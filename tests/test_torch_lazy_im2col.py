"""Port parity, lazy im2col: ``extract_tap_slabs`` array-equal to the
reference's; ``sparse_conv2d_nhwc(im2col="lazy")`` within 1e-5 of the
reference's lazy path (its XLA slab executor) with equal occupancy and
schedule records, and bitwise equal to the port's own ``taps`` path; the
demotions under the dense schedule and activation compaction, the all-dead
work list, and the channel-layout ``ValueError``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sparse_conv as rsc
from repro.kernels.worklist_core import build_worklist as r_build
from repro.sparsity import conv as rconv
from repro_torch.kernels import sparse_conv as tsc
from repro_torch.kernels.worklist_core import build_worklist
from repro_torch.sparsity import conv as tconv

CPU = torch.device("cpu")
GEOMS = [(1, "SAME"), (2, "VALID"), (2, "SAME"), (1, "VALID")]


def _layer(rng, *, k=3, cin=16, cout=24, bk=8, bn=8, B=2, H=9, W=11,
           keep=0.5):
    """Chunk-sparse tap-layout filters and a sparse NHWC map."""
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    live = rng.random((k * k * cin // bk, cout // bn)) < keep
    w = (w.reshape(-1, cout) * np.repeat(np.repeat(live, bk, 0), bn, 1)) \
        .reshape(k, k, cin, cout)
    x = np.abs(rng.normal(size=(B, H, W, cin))).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0.0
    x[0, :3] = 0.0                               # dead row blocks
    kw = dict(layout="tap", bk=bk, bn=bn)
    return x, w, rconv.pack_conv_filters(w, **kw), \
        tconv.pack_conv_filters(w, device=CPU, **kw)


@pytest.mark.parametrize("stride,padding", GEOMS)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bk", [8, 16])
def test_extract_tap_slabs_equal(rng, stride, padding, k, bk):
    x, _, _, _ = _layer(rng, k=k, bk=bk)
    kb = k * k * x.shape[-1] // bk
    chunks = np.sort(rng.choice(kb, size=max(kb // 2, 1), replace=False))
    oh, ow = tsc.conv_out_size(9, 11, k, k, stride, padding)
    m_pad = oh * ow + (-(oh * ow)) % 16
    t = tsc.extract_tap_slabs(torch.as_tensor(x), k, k, stride, padding,
                              chunks=chunks, bk=bk, m_pad=m_pad)
    r = rsc.extract_tap_slabs(jnp.asarray(x), k, k, stride, padding,
                              chunks=chunks, bk=bk, m_pad=m_pad)
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    # each slab is its column block of the taps patch matrix
    patches, _ = tsc.extract_patches(torch.as_tensor(x), k, k, stride,
                                     padding, strategy="taps")
    for s, c in enumerate(chunks):
        col = patches[..., c * bk:(c + 1) * bk]
        np.testing.assert_array_equal(
            t[s].reshape(2, m_pad, bk)[:, :oh * ow].numpy(), col.numpy())


def test_extract_tap_slabs_needs_whole_channel_groups(rng):
    x, _, _, _ = _layer(rng)
    with pytest.raises(ValueError, match="cin % bk"):
        tsc.extract_tap_slabs(torch.as_tensor(x), 3, 3, 1, "SAME",
                              chunks=[0], bk=12, m_pad=128)


@pytest.mark.parametrize("stride,padding", GEOMS)
@pytest.mark.parametrize("bm_rows", [16, 64])
@pytest.mark.parametrize("k,bk", [(3, 8), (3, 16), (1, 8)])
def test_lazy_layer_matches_reference_and_taps(rng, stride, padding,
                                               bm_rows, k, bk):
    x, _, rw, tw = _layer(rng, k=k, bk=bk)
    kw = dict(stride=stride, padding=padding, layout="tap", bm_rows=bm_rows,
              emit_occupancy=True, report_schedule=True)
    xt = torch.as_tensor(x)
    lazy, la = tsc.sparse_conv2d_nhwc(xt, tw, k, k, 24, im2col="lazy", **kw)
    taps, ta = tsc.sparse_conv2d_nhwc(xt, tw, k, k, 24, im2col="taps", **kw)
    ref, ra = rsc.sparse_conv2d_nhwc(jnp.asarray(x), rw, k, k, 24,
                                     im2col="lazy", executor="xla", **kw)
    assert torch.equal(lazy, taps)
    assert torch.equal(la["occupancy"], ta["occupancy"])
    ref = np.asarray(ref)
    rel = np.abs(lazy.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= 1e-5, rel
    np.testing.assert_array_equal(la["occupancy"].numpy(),
                                  np.asarray(ra["occupancy"]))
    assert la["schedule"] == ra["schedule"]
    for key in ("m_img", "k_total", "oh", "ow"):
        assert int(la[key]) == int(ra[key])


def test_slab_walk_equals_the_walker_on_the_patch_matrix(rng):
    """The plain slab walk (``wl.k`` remapped to the live slabs) gives the
    plain walker's bits on the whole patch matrix, with any epilogue."""
    from repro_torch.kernels.worklist_core import worklist_spmm_plain
    x, _, _, tw = _layer(rng, H=8, W=8)
    xt = torch.as_tensor(x)
    patches, _ = tsc.extract_patches(xt, 3, 3, 1, "SAME", strategy="taps")
    flat = patches.reshape(2 * 64, -1)
    wl = build_worklist(tw.host_indices(), 4, mb_per_img=2)
    for act in (None, "relu", "gelu"):
        kw = dict(bk=8, bn=8, bm_rows=32, sub_m=8, act=act,
                  emit_occupancy=True)
        got = tsc.worklist_spmm_slabs_plain(xt, tw.vals, wl, kh=3, kw=3,
                                            stride=1, padding="SAME",
                                            m_pad=64, **kw)
        want = worklist_spmm_plain(flat, tw.vals, wl, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_lazy_demotes_to_taps_where_the_patch_matrix_is_needed(rng):
    """The dense schedule (and count_macs, which takes it) and activation
    compaction demote lazy to taps, as the reference does (its dense grid
    is a Pallas kernel that does not trace on the installed jax, so the
    dense cases are held to the port's taps path alone)."""
    x, _, rw, tw = _layer(rng)
    xt = torch.as_tensor(x)
    for extra in (dict(schedule="dense", emit_occupancy=True),
                  dict(count_macs=True),
                  dict(compact_activations=True, report_schedule=True)):
        kw = dict(layout="tap", bm_rows=32, **extra)
        lazy, la = tsc.sparse_conv2d_nhwc(xt, tw, 3, 3, 24, im2col="lazy",
                                          **kw)
        taps, ta = tsc.sparse_conv2d_nhwc(xt, tw, 3, 3, 24, im2col="taps",
                                          **kw)
        assert torch.equal(lazy, taps)
        assert la.get("schedule") == ta.get("schedule")
        for key in ("occupancy", "mac_counts"):
            if key in ta:
                assert torch.equal(la[key], ta[key])
        if "compact_activations" in extra:
            ref, ra = rsc.sparse_conv2d_nhwc(jnp.asarray(x), rw, 3, 3, 24,
                                             im2col="lazy", executor="xla",
                                             **kw)
            ref = np.asarray(ref)
            assert np.abs(lazy.numpy() - ref).max() <= \
                1e-5 * np.abs(ref).max()
            assert la["schedule"] == ra["schedule"]


def test_all_dead_work_list_gives_zeros(rng):
    """A layer with no stored chunk: zeros and zero occupancy, as the
    reference's slab executor returns."""
    x, _, _, _ = _layer(rng)
    w = np.zeros((3, 3, 16, 24), np.float32)
    rw = rconv.pack_conv_filters(w, layout="tap", bk=8, bn=8)
    tw = tconv.pack_conv_filters(w, layout="tap", bk=8, bn=8, device=CPU)
    kw = dict(layout="tap", bm_rows=32, emit_occupancy=True, im2col="lazy")
    out, aux = tsc.sparse_conv2d_nhwc(torch.as_tensor(x), tw, 3, 3, 24, **kw)
    ref, ra = rsc.sparse_conv2d_nhwc(jnp.asarray(x), rw, 3, 3, 24,
                                     executor="xla", **kw)
    assert not out.any() and not aux["occupancy"].any()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(aux["occupancy"].numpy(),
                                  np.asarray(ra["occupancy"]))
    wl = build_worklist(tw.host_indices(), 4)
    assert wl.mac_steps == r_build(rw.host_indices(), 4).mac_steps == 0


def test_lazy_needs_the_tap_layout(rng):
    x, w, _, _ = _layer(rng)
    tw = tconv.pack_conv_filters(w, layout="channel", device=CPU)
    rw = rconv.pack_conv_filters(w, layout="channel")
    with pytest.raises(ValueError, match="layout='tap'"):
        tsc.sparse_conv2d_nhwc(torch.as_tensor(x), tw, 3, 3, 24,
                               im2col="lazy")
    with pytest.raises(ValueError):
        rsc.sparse_conv2d_nhwc(jnp.asarray(x), rw, 3, 3, 24, im2col="lazy",
                               executor="xla")
