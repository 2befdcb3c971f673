"""What ``im2col="auto"`` resolves to in the port's conv layer: K1's
tap-slab operand (``"lazy"``) at ``layout="tap"`` on the compact static
schedule, ``"taps"`` where lazy is demoted (the dense schedule, activation
compaction), ``"slices"`` at ``layout="channel"``; and the forwards that
take the default give bitwise the outputs of the same forwards pinned to
``"taps"``. No JAX: the port against itself."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import sparse_conv as tsc
from repro_torch.sparsity import conv as tconv
from repro_torch.vision import (ImageRequest, VisionEngine,
                                build_vision_model, compile_forward,
                                forward, graphed_forward)

CPU = torch.device("cpu")


@pytest.fixture
def paths(monkeypatch):
    """The operand each ``sparse_conv2d_nhwc`` call built: ``"lazy"`` for
    a walk of the tap slabs, else the strategy of its patch matrix."""
    seen = []
    slabs, patches = tsc.worklist_spmm_slabs, tsc.extract_patches

    def spy_slabs(*a, **k):
        seen.append("lazy")
        return slabs(*a, **k)

    def spy_patches(*a, strategy="auto", **k):
        seen.append(strategy)
        return patches(*a, strategy=strategy, **k)

    monkeypatch.setattr(tsc, "worklist_spmm_slabs", spy_slabs)
    monkeypatch.setattr(tsc, "extract_patches", spy_patches)
    return seen


def _layer(rng, layout, cin=16, cout=24, bk=8, bn=8):
    w = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    w[rng.random(w.shape) >= 0.4] = 0.0
    x = np.abs(rng.normal(size=(2, 9, 7, cin))).astype(np.float32)
    x[rng.random(x.shape) >= 0.5] = 0.0
    x[0, :3] = 0.0                               # dead row blocks
    packed = tconv.pack_conv_filters(w, layout=layout, bk=bk, bn=bn,
                                     device=CPU)
    return torch.as_tensor(x), packed, cout


@pytest.mark.parametrize("layout,schedule,compact_activations,want", [
    ("tap", "compact", False, "lazy"),
    ("tap", "compact", True, "taps"),
    ("tap", "dense", False, "taps"),
    ("tap", "dense", True, "taps"),
    ("channel", "compact", False, "slices"),
    ("channel", "compact", True, "slices"),
    ("channel", "dense", False, "slices"),
    ("channel", "dense", True, "slices"),
])
def test_auto_takes_tap_slabs_exactly_at_tap_layout_compact_static(
        rng, paths, layout, schedule, compact_activations, want):
    """``auto`` reads the tap slabs at tap layout on the compact static
    schedule and builds the patch matrix everywhere else, with the bits of
    the strategy it resolved to pinned by the caller."""
    x, packed, cout = _layer(rng, layout)
    kw = dict(layout=layout, schedule=schedule,
              compact_activations=compact_activations, bm_rows=32,
              emit_occupancy=True, wl_cache={})
    got, ga = tsc.sparse_conv2d_nhwc(x, packed, 3, 3, cout, **kw)
    assert paths == [want]
    pinned = "taps" if layout == "tap" else "slices"
    ref, ra = tsc.sparse_conv2d_nhwc(x, packed, 3, 3, cout, im2col=pinned,
                                     **kw)
    assert paths == [want, pinned]
    assert torch.equal(got, ref)
    assert torch.equal(ga["occupancy"], ra["occupancy"])
    assert ga.get("schedule") == ra.get("schedule")


def test_count_macs_keeps_auto_on_the_patch_matrix(rng, paths):
    """``count_macs`` takes the dense grid, so ``auto`` builds the taps
    patch matrix there."""
    x, packed, cout = _layer(rng, "tap")
    tsc.sparse_conv2d_nhwc(x, packed, 3, 3, cout, layout="tap", bm_rows=32,
                           count_macs=True)
    assert paths == ["taps"]


def pin_taps(model, size):
    """Every tap-layout layer tuned to the taps patch matrix at the
    defaults' 128-row blocks and its pack-time bn: ``use_tuned=True`` then
    runs the default forward with the patch matrix built (a network-wide
    ``im2col="taps"`` is refused at the channel-layout stem)."""
    from repro_torch.kernels.autotune import ConvTileConfig, autotune_conv
    from repro_torch.vision import layer_geometry
    for layer, g in zip(model.layers, layer_geometry(model, size)):
        c = layer.conv
        if c.layout == "tap":
            autotune_conv(c, g["m_img"], candidates=[ConvTileConfig(
                bm_rows=128, bn=c.packed.bn, sub_m=8, im2col="taps")])


@pytest.fixture(scope="module")
def vgg_head():
    """VGG16's first two layers on the chunk pattern: the 3-channel stem
    (channel layout) and one 64-channel layer (tap layout), pinned to taps
    under ``use_tuned``."""
    model = build_vision_model("VGGNet", num_layers=2, pattern="chunk",
                               seed=0, device=CPU)
    assert [layer.conv.layout for layer in model.layers] == ["channel",
                                                             "tap"]
    pin_taps(model, 16)
    x = np.abs(np.random.default_rng(7).normal(size=(3, 16, 16, 3)))
    x[np.random.default_rng(8).random(x.shape) >= 0.5] = 0.0
    return model, torch.as_tensor(x.astype(np.float32))


def test_vgg_head_forward_default_bitwise_taps(vgg_head, paths):
    """The default forward walks the tap slabs at the tap layer and equals
    the forward pinned to ``taps`` bitwise, in every forward entry point."""
    model, x = vgg_head
    got, _ = forward(model, x)
    assert paths == ["slices", "lazy"]
    want, _ = forward(model, x, use_tuned=True)
    assert paths[2:] == ["slices", "taps"]
    assert torch.equal(got, want)
    assert torch.equal(compile_forward(model)(x), want)
    assert torch.equal(graphed_forward(model)(x), want)
    assert paths[4:] == ["slices", "lazy"] * 2


def test_vgg_head_stats_forward_stays_on_taps(vgg_head, paths):
    """``forward(collect_stats=True)`` runs the dense grid with activation
    compaction, so ``auto`` keeps the patch matrix there."""
    model, x = vgg_head
    forward(model, x, collect_stats=True)
    assert paths == ["slices", "taps"]


def test_vgg_head_engine_default_bitwise_taps(vgg_head):
    """``VisionEngine`` at its defaults serves bitwise the outputs of an
    engine pinned to the taps patch matrix."""
    model, x = vgg_head
    reqs = [ImageRequest(rid=i, image=x[i % 3].numpy()) for i in range(5)]
    got = VisionEngine(model, num_slots=2).run(reqs)
    want = VisionEngine(model, num_slots=2, use_tuned=True).run(reqs)
    assert sorted(got) == sorted(want) == list(range(5))
    assert all(np.array_equal(got[r], want[r]) for r in want)


def test_launch_counter_counts_eager_and_captured_launches():
    """A ``LaunchCounter`` (the walker's tap-slab count) keeps its count as
    a kernel's ``launches`` is kept: eager launches on the counter, those
    made while a graph is captured on the graph's tally, which each replay
    adds (``CapturedGraph``)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.worklist_core import (WALK, WALK_TAP_SLABS,
                                                   WALK_TAP_SLABS_PLAIN)
    for c in (WALK, WALK_TAP_SLABS, WALK_TAP_SLABS_PLAIN):
        assert isinstance(c, _cuda.LaunchCounter)
    c = _cuda.LaunchCounter("probe")
    c._add(False)
    tally = {}
    with _cuda.capture_tally(tally):
        c._add(True)
        c._add(True)
    assert c.launches == 1 and tally == {c: 2}
