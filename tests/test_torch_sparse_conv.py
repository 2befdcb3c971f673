"""Port parity, sparse conv: im2col, the compact layer against the
reference's XLA executor (rel err 1e-5, equal occupancy, equal schedule
records), and the dense-grid plain version's output and executed-MAC
counters against the reference's pure skip model
``repro.kernels.ops.sparse_matmul_tile_stats`` (the reference's dense-grid
Pallas kernel cannot run on the installed jax)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import prune_by_magnitude
from repro.kernels import ops as rops
from repro.kernels import sparse_conv as rsc
from repro.sparsity import conv as rconv
from repro.sparsity.structured import prune_chunk_aligned
from repro_torch.kernels import sparse_conv as tsc
from repro_torch.sparsity import conv as tconv

CPU = torch.device("cpu")


def _operands(rng, B=2, H=9, W=11, cin=8, cout=20, k=3, density=0.4,
              map_density=0.6):
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    w *= prune_by_magnitude(w, density, axis_out=-1)
    x = np.abs(rng.normal(size=(B, H, W, cin))).astype(np.float32)
    x[rng.random(x.shape) >= map_density] = 0.0
    x[0, :4] = 0.0                               # dead row blocks
    return x, w


def _packs(w, layout="channel", bk=None, bn=None):
    kw = dict(layout=layout, bk=bk, bn=bn)
    return rconv.pack_conv_filters(w, **kw), \
        tconv.pack_conv_filters(w, device=CPU, **kw)


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("strategy", ["patches", "slices", "taps"])
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "VALID"),
                                            ((1, 2), ((2, 0), (1, 1)))])
def test_extract_patches_equal(rng, strategy, stride, padding):
    x, _ = _operands(rng, H=13, W=9)
    t, tg = tsc.extract_patches(torch.as_tensor(x), 3, 3, stride, padding,
                                strategy=strategy)
    r, rg = rsc.extract_patches(jnp.asarray(x), 3, 3, stride, padding,
                                strategy=strategy)
    assert tuple(tg) == tuple(rg)
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    assert tsc.conv_out_size(13, 9, 3, 3, stride, padding) == \
        tuple(int(v) for v in rsc.conv_out_size(13, 9, 3, 3, stride, padding))


def test_extract_patches_rejects_unknown_strategy(rng):
    x, _ = _operands(rng)
    with pytest.raises(ValueError):
        tsc.extract_patches(torch.as_tensor(x), 3, 3, 1, "SAME",
                            strategy="im2col")


def _schedule_equal(t, r):
    """aux['schedule'] records: ints equal, the combining model's floats
    equal too (both are the same numpy arithmetic)."""
    assert t == r


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
@pytest.mark.parametrize("compact_acts", [False, True])
def test_compact_layer_matches_reference_xla(rng, stride, padding,
                                             compact_acts):
    x, w = _operands(rng)
    rw, tw = _packs(w)
    kw = dict(stride=stride, padding=padding, emit_occupancy=True,
              compact_activations=compact_acts, report_schedule=True)
    t_out, t_aux = tsc.sparse_conv2d_nhwc(torch.as_tensor(x), tw, 3, 3, 20,
                                          wl_cache={}, **kw)
    r_out, r_aux = rsc.sparse_conv2d_nhwc(jnp.asarray(x), rw, 3, 3, 20,
                                          executor="xla", wl_cache={}, **kw)
    assert t_out.shape == r_out.shape
    assert _rel(t_out.numpy(), r_out) <= 1e-5
    np.testing.assert_array_equal(t_aux["occupancy"].numpy(),
                                  np.asarray(r_aux["occupancy"]))
    _schedule_equal(t_aux["schedule"], r_aux["schedule"])
    for k in ("m_img", "k_total", "oh", "ow"):
        assert t_aux[k] == r_aux[k]


def test_tap_layout_layer_matches_reference_xla(rng):
    x, w = _operands(rng, cin=32, cout=64, density=1.0)
    w, _ = prune_chunk_aligned(w, 0.5, bk=16, bn=32)
    rw, tw = _packs(w, layout="tap", bk=16, bn=32)
    t_out, t_aux = tsc.sparse_conv2d_nhwc(torch.as_tensor(x), tw, 3, 3, 64,
                                          layout="tap", wl_cache={})
    r_out, r_aux = rsc.sparse_conv2d_nhwc(jnp.asarray(x), rw, 3, 3, 64,
                                          layout="tap", executor="xla",
                                          wl_cache={})
    assert _rel(t_out.numpy(), r_out) <= 1e-5
    _schedule_equal(t_aux["schedule"], r_aux["schedule"])
    assert t_aux["schedule"]["flush_only_steps"] == 0
    assert tw.density() == pytest.approx(0.5)   # real dead chunks


def test_wl_cache_reused_across_calls(rng):
    x, w = _operands(rng)
    _, tw = _packs(w)
    cache = {}
    xt = torch.as_tensor(x)
    a, _ = tsc.sparse_conv2d_nhwc(xt, tw, 3, 3, 20, wl_cache=cache)
    wl = next(iter(cache.values()))
    b, _ = tsc.sparse_conv2d_nhwc(xt, tw, 3, 3, 20, wl_cache=cache)
    assert list(cache.values()) == [wl]
    assert torch.equal(a, b)


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("fuse_relu", [True, False])
def test_dense_grid_plain_output_matches_reference_xla(rng, two_sided,
                                                       fuse_relu):
    x, w = _operands(rng)
    rw, tw = _packs(w)
    t_out, t_aux = tsc.sparse_conv2d_nhwc(
        torch.as_tensor(x), tw, 3, 3, 20, schedule="dense",
        two_sided=two_sided, fuse_relu=fuse_relu, emit_occupancy=True)
    r_out, r_aux = rsc.sparse_conv2d_nhwc(
        jnp.asarray(x), rw, 3, 3, 20, executor="xla", fuse_relu=fuse_relu,
        emit_occupancy=True)
    assert _rel(t_out.numpy(), r_out) <= 1e-5
    np.testing.assert_array_equal(t_aux["occupancy"].numpy(),
                                  np.asarray(r_aux["occupancy"]))


@pytest.mark.parametrize("sub_m", [8, 32])
@pytest.mark.parametrize("map_density", [0.05, 0.6])
def test_dense_grid_counts_match_tile_stats_model(rng, sub_m, map_density):
    """Two-sided: executed sub-block MACs == the reference's pure skip
    model. One-sided: stored chunks x row blocks (whole-tile counts)."""
    x, w = _operands(rng, map_density=map_density)
    rw, tw = _packs(w)
    patches, _ = rsc.extract_patches(jnp.asarray(x), 3, 3, 1, "SAME",
                                     strategy="slices")
    m_img = patches.shape[1]
    m_pad = m_img + (-m_img) % 128
    flat = np.pad(np.asarray(patches),
                  ((0, 0), (0, m_pad - m_img),
                   (0, rw.shape[0] - patches.shape[2]))).reshape(
        -1, rw.shape[0])
    ft = torch.as_tensor(flat)
    _, cnt2 = tsc.sparse_conv_spmm(ft, tw.indices, tw.vals, bk=tw.bk,
                                   bn=tw.bn, sub_m=sub_m, two_sided=True,
                                   count_macs=True)
    model = rops.sparse_matmul_tile_stats(
        jnp.asarray(flat), rw.indices, k_total=rw.shape[0], bk=rw.bk,
        sub_m=sub_m)
    assert int(cnt2.sum()) == int(model["executed"])
    _, cnt1 = tsc.sparse_conv_spmm(ft, tw.indices, tw.vals, bk=tw.bk,
                                   bn=tw.bn, sub_m=sub_m, two_sided=False,
                                   count_macs=True)
    mb = flat.shape[0] // 128
    assert int(cnt1.sum()) == int((tw.host_indices() >= 0).sum()) * mb
    assert cnt1.shape == cnt2.shape == (tw.n_blocks, mb)


def test_count_macs_switches_to_dense_grid(rng):
    x, w = _operands(rng)
    _, tw = _packs(w)
    out, aux = tsc.sparse_conv2d_nhwc(torch.as_tensor(x), tw, 3, 3, 20,
                                      count_macs=True)
    assert aux["mac_counts"].shape == (tw.n_blocks, 2 * 1)
    assert "static_scheduled_steps" in aux["schedule"]


def test_lazy_im2col_and_layout_mismatch_raise(rng):
    x, w = _operands(rng)
    _, tw = _packs(w)
    xt = torch.as_tensor(x)
    with pytest.raises(ValueError, match="needs layout='tap'"):
        tsc.sparse_conv2d_nhwc(xt, tw, 3, 3, 20, im2col="lazy")
    with pytest.raises(ValueError):
        tsc.sparse_conv2d_nhwc(xt, tw, 3, 3, 20, im2col="taps")
    with pytest.raises(ValueError):
        tsc.sparse_conv2d_nhwc(xt, tw, 3, 3, 20, schedule="grid")
