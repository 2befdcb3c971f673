"""Port parity, whole slice: the VGG head built, run and served by
``repro_torch`` against the JAX reference (``forward(executor="xla")``,
``dense_forward``, the per-layer schedule records), the weight carry-over of
``repro_torch.convert``, and the port's own invariants (engine == solo,
round-robin lane spread). Small sizes: 2-3 layers at 16-24 px."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sparse_conv import sparse_conv2d_nhwc as r_conv_layer
from repro.launch.vision import blob_images as r_blob_images
from repro.vision import (VisionEngine as RVisionEngine, build_vision_model
                          as r_build, dense_forward as r_dense_forward,
                          forward as r_forward, layer_geometry as
                          r_layer_geometry)
from repro.vision.model import max_pool as r_max_pool
from repro.vision import ImageRequest as RImageRequest
from repro_torch.convert import model_from_reference
from repro_torch.launch import vision as t_launch
from repro_torch.vision import (ImageRequest, VisionEngine,
                                build_vision_model, compile_forward,
                                dense_forward, forward, layer_geometry,
                                layer_table, max_pool, measured_densities,
                                oracle_check, schedule_summary)

CPU = torch.device("cpu")
BENCH = dict(density=0.334, num_layers=2, pattern="chunk", seed=0)


def _bench_blob(batch=1, size=24, live_frac=0.12, seed=0):
    """The committed BENCH_vision.json input (VGG head, 24 px)."""
    return r_blob_images(np.random.default_rng(seed), batch, size, live_frac)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _ref_layers(rmodel):
    return [dict(w_dense=l.conv.w_dense, perm=l.conv.perm,
                 indices=np.asarray(l.conv.packed.indices),
                 vals=np.asarray(l.conv.packed.vals), bk=l.conv.packed.bk,
                 bn=l.conv.packed.bn, layout=l.conv.layout,
                 pattern=l.conv.pattern, stride=l.stride,
                 padding=l.padding, pool_after=l.pool_after)
            for l in rmodel.layers]


@pytest.fixture(scope="module")
def models():
    """The bench-settings VGG head built by both packages."""
    return r_build("VGGNet", **BENCH), \
        build_vision_model("VGGNet", device=CPU, **BENCH)


@pytest.mark.parametrize("pattern", ["unstructured", "chunk"])
def test_build_vision_model_equal_to_reference(pattern):
    r = r_build("VGGNet", density=0.334, num_layers=3, pattern=pattern)
    t = build_vision_model("VGGNet", density=0.334, num_layers=3,
                           pattern=pattern, device=CPU)
    assert (t.name, t.input_size, t.density, t.num_layers) == \
        (r.name, r.input_size, r.density, r.num_layers)
    for tl, rl in zip(t.layers, r.layers):
        np.testing.assert_array_equal(tl.conv.w_dense, rl.conv.w_dense)
        np.testing.assert_array_equal(tl.conv.perm, rl.conv.perm)
        np.testing.assert_array_equal(tl.conv.packed.indices.numpy(),
                                      np.asarray(rl.conv.packed.indices))
        np.testing.assert_array_equal(tl.conv.packed.vals.numpy(),
                                      np.asarray(rl.conv.packed.vals))
        assert (tl.stride, tl.padding, tl.pool_after, tl.conv.layout) == \
            (rl.stride, rl.padding, rl.pool_after, rl.conv.layout)


def test_layer_geometry_equal_to_reference(models):
    r = r_build("VGGNet", density=0.334, num_layers=5)
    t = build_vision_model("VGGNet", density=0.334, num_layers=5, device=CPU)
    for size in (224, 24, 17):
        assert layer_geometry(t, size) == r_layer_geometry(r, size)


@pytest.mark.parametrize("pattern,layers,size,live", [
    ("chunk", 2, 24, 0.12),            # the BENCH_vision.json head
    ("unstructured", 3, 20, 0.4), ("chunk", 3, 20, 0.4)])
def test_forward_matches_reference_xla(pattern, layers, size, live):
    r = r_build("VGGNet", density=0.334, num_layers=layers, pattern=pattern)
    t = build_vision_model("VGGNet", density=0.334, num_layers=layers,
                           pattern=pattern, device=CPU)
    x = _bench_blob(batch=2, size=size, live_frac=live)
    rout, _ = r_forward(r, jnp.asarray(x), executor="xla")
    tout, stats = forward(t, torch.as_tensor(x))
    assert stats == []
    assert tout.shape == rout.shape
    assert _rel(tout.numpy(), rout) <= 1e-5


def test_dense_forward_and_pool_match_reference(models):
    r, t = models
    x = _bench_blob(batch=2, size=17, live_frac=0.5)
    assert _rel(dense_forward(t, torch.as_tensor(x)).numpy(),
                r_dense_forward(r, jnp.asarray(x))) <= 1e-5
    y = np.abs(np.random.default_rng(1).normal(size=(2, 7, 5, 4))) \
        .astype(np.float32)
    for win, s in ((2, 2), (3, 2), (8, 2)):
        np.testing.assert_array_equal(
            max_pool(torch.as_tensor(y), win, s).numpy(),
            np.asarray(r_max_pool(jnp.asarray(y), win, s)))


def test_collect_stats_schedule_matches_reference_records(models):
    """The instrumented path's per-layer schedule counters equal what the
    reference computes with compact_activations=True, report_schedule=True;
    at the bench settings that is 16 scheduled = 13 live + 3 flush-only of
    20 dense-grid steps (BENCH_vision.json)."""
    r, t = models
    x = _bench_blob()
    out, stats, rel = oracle_check(t, torch.as_tensor(x))
    assert rel <= 1e-5
    xr = jnp.asarray(x)
    keys = ("scheduled_steps", "live_chunk_steps", "flush_only_steps",
            "dense_grid_steps", "static_scheduled_steps")
    for s, layer in zip(stats, r.layers):
        c = layer.conv
        xr, aux = r_conv_layer(xr, c.packed, c.kh, c.kw, c.cout,
                               stride=layer.stride, padding=layer.padding,
                               layout=c.layout, executor="xla",
                               compact_activations=True,
                               report_schedule=True)
        sched = aux["schedule"]
        assert {k: s[k] for k in keys} == {k: sched[k] for k in keys}
        assert s["schedule_requests"] == sched["combining"]["requests"]
        assert s["schedule_fetches"] == sched["combining"]["fetches"]
        if layer.pool_after is not None:
            xr = r_max_pool(xr, *layer.pool_after)
    tot = schedule_summary(stats)
    assert (tot["scheduled_steps"], tot["live_chunk_steps"],
            tot["flush_only_steps"], tot["dense_grid_steps"]) == \
        (16, 13, 3, 20)
    assert stats[1]["dead_chunk_fraction"] == pytest.approx(2 / 3, abs=0.05)
    fd, md = measured_densities(stats)
    assert 0.3 < fd < 0.4 and 0.0 < md < 1.0
    assert len(layer_table(stats, with_paper=True)) == 3


def test_model_from_reference_round_trip(models):
    r, t = models
    c = model_from_reference(_ref_layers(r), device=CPU)
    assert (c.name, c.input_size, c.density) == \
        (r.name, r.input_size, r.density)
    x = torch.as_tensor(_bench_blob(batch=2, size=16, live_frac=0.5))
    assert torch.equal(forward(c, x)[0], forward(t, x)[0])
    for cl, tl in zip(c.layers, t.layers):
        assert cl.conv.packed.shape == tl.conv.packed.shape
        assert (cl.stride, cl.padding, cl.pool_after) == \
            (tl.stride, tl.padding, tl.pool_after)
    bad = _ref_layers(r)
    del bad[0]["vals"]
    with pytest.raises(KeyError):
        model_from_reference(bad, device=CPU)


def _requests(rng, n, size=12, stagger=0):
    return [ImageRequest(rid=i, image=np.abs(
        rng.normal(size=(size, size, 3))).astype(np.float32),
        arrival=i * stagger) for i in range(n)]


def test_engine_matches_solo_forward_bitwise(rng, models):
    _, t = models
    eng = VisionEngine(t, num_slots=4)
    reqs = _requests(rng, 6, stagger=1)
    produced = eng.run(reqs)
    assert sorted(produced) == list(range(6))
    solo = compile_forward(t)
    for r in reqs:
        np.testing.assert_array_equal(
            produced[r.rid], solo(torch.as_tensor(r.image[None]))[0].numpy())
    assert eng.stats.images == 6
    assert 0 < eng.stats.slot_utilization < 1


def test_engine_schedule_counters_match_reference(rng):
    r = r_build("VGGNet", **BENCH)      # fresh: no work lists cached yet
    t = build_vision_model("VGGNet", device=CPU, **BENCH)
    reqs = _requests(rng, 4)
    eng = VisionEngine(t, num_slots=2)
    assert eng.schedule_counters() is None
    eng.run(reqs)
    reng = RVisionEngine(r, num_slots=2, executor="xla",
                         verify_artifacts=False)
    reng.run([RImageRequest(q.rid, q.image, q.arrival) for q in reqs])
    assert eng.schedule_counters() == reng.schedule_counters()


def test_engine_round_robin_spreads_lanes(rng, models):
    _, t = models
    eng = VisionEngine(t, num_slots=3)
    lanes = []
    for r in _requests(rng, 3, size=8):
        eng.submit(r)
        eng._admit_ready()
        lanes.append(int(np.nonzero(eng.slot_req == r.rid)[0][0]))
        eng.step()
    assert lanes == [0, 1, 2]        # rotated scan, not pinned to lane 0
    with pytest.raises(ValueError):
        eng.submit(ImageRequest(9, np.ones((10, 10, 3), np.float32)))


def test_not_ported_options_raise(models):
    """The mesh is ported (``tests/test_torch_dist_vision.py``): what is
    not a mesh (no dim names) is refused; the artifact verifier is ported
    and on by default (``tests/test_torch_analysis.py``): a clean model is
    admitted; ``use_tuned`` is ported (``tests/test_torch_autotune.py``): on
    layers without a tuning record it keeps the global knobs."""
    _, t = models
    VisionEngine(t, verify_artifacts=True)
    with pytest.raises(ValueError, match="dim names"):
        VisionEngine(t, mesh=object())
    with pytest.raises(ValueError, match="dim names"):
        compile_forward(t, mesh=object())
    assert all(layer.conv.tuned is None for layer in t.layers)
    assert layer_geometry(t, 24, use_tuned=True) == layer_geometry(t, 24)
    x = torch.zeros((1, 8, 8, 3))
    assert torch.equal(compile_forward(t, use_tuned=True)(x),
                       compile_forward(t)(x))


def test_launcher_smoke_on_cpu(capsys):
    t_launch.main(["--smoke", "--device", "cpu", "--pattern", "chunk",
                   "--requests", "3"])
    out = capsys.readouterr().out
    assert "engine output matches solo forward" in out
    assert "device cpu" in out
