"""Port parity, the Table-1 chains other than VGG16 (AlexNet, ResNet-18,
ResNet-50) and the port's examples.

Small sizes: AlexNet whole (its 11x11 stride-4 VALID stem and the pools
55 -> 27 -> 13 that do not halve) at 67 px; ResNet-18 and ResNet-50 cut to
4 layers (the 7x7 stride-2 stem, ResNet-50's 1x1 layers) at 32 px. Each
net is built by both packages from one seed and held to the reference:
host arrays equal, the instrumented path's schedule counters equal the
reference's ``executor="xla"`` layer calls, outputs within rel err 1e-5 of
its ``forward(executor="xla")``. Then ``examples/torch_sparse_cnn_sim.py``
against the reference's cycle model, and the other three examples on the
CPU at tiny sizes."""
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as RS
from repro.kernels.sparse_conv import sparse_conv2d_nhwc as r_conv_layer
from repro.launch.vision import blob_images as r_blob_images
from repro.vision import (VisionEngine as RVisionEngine, build_vision_model
                          as r_build, dense_forward as r_dense_forward,
                          forward as r_forward, layer_geometry as
                          r_layer_geometry,
                          measured_densities as r_measured_densities)
from repro.vision import ImageRequest as RImageRequest
from repro.vision.model import max_pool as r_max_pool
from repro_torch.vision import (ImageRequest, VisionEngine,
                                build_vision_model, compile_forward,
                                dense_forward, forward, layer_geometry,
                                oracle_check)

CPU = torch.device("cpu")
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# (arch, layers, px, pattern)
NETS = [("AlexNet", None, 67, "chunk"), ("AlexNet", None, 67, "unstructured"),
        ("ResNet18", 4, 32, "chunk"), ("ResNet50", 4, 32, "unstructured"),
        ("ResNet50", 4, 30, "chunk")]
IDS = [f"{a}-{p}" for a, _, _, p in NETS]
SCHED_KEYS = ("scheduled_steps", "live_chunk_steps", "flush_only_steps",
              "dense_grid_steps", "static_scheduled_steps")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


_BUILT = {}


def _models(arch, layers, pattern):
    """Both packages' nets, built once per config for the module."""
    key = (arch, layers, pattern)
    if key not in _BUILT:
        _BUILT[key] = (
            r_build(arch, num_layers=layers, pattern=pattern, seed=0),
            build_vision_model(arch, num_layers=layers, pattern=pattern,
                               seed=0, device=CPU))
    return _BUILT[key]


def _images(arch, size, batch=2):
    return r_blob_images(np.random.default_rng(0), batch, size,
                         RS.BENCHMARKS[arch].map_density)


def example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,layers,size,pattern", NETS, ids=IDS)
def test_built_net_equal_to_reference(arch, layers, size, pattern):
    """Filters, permutations, packed indices and values, strides, pads,
    pools, layouts and the per-size geometry walk are the reference's."""
    r, t = _models(arch, layers, pattern)
    assert (t.name, t.input_size, t.density, t.num_layers) == \
        (r.name, r.input_size, r.density, r.num_layers)
    for tl, rl in zip(t.layers, r.layers):
        np.testing.assert_array_equal(tl.conv.w_dense, rl.conv.w_dense)
        np.testing.assert_array_equal(tl.conv.perm, rl.conv.perm)
        np.testing.assert_array_equal(tl.conv.packed.indices.numpy(),
                                      np.asarray(rl.conv.packed.indices))
        np.testing.assert_array_equal(tl.conv.packed.vals.numpy(),
                                      np.asarray(rl.conv.packed.vals))
        assert (tl.stride, tl.padding, tl.pool_after, tl.conv.layout,
                tl.conv.pattern, tl.conv.packed.bk, tl.conv.packed.bn) == \
            (rl.stride, rl.padding, rl.pool_after, rl.conv.layout,
             rl.conv.pattern, rl.conv.packed.bk, rl.conv.packed.bn)
    for px in (size, r.input_size):
        assert layer_geometry(t, px) == r_layer_geometry(r, px)


@pytest.mark.parametrize("arch,layers,size,pattern", NETS, ids=IDS)
def test_forward_matches_reference_xla(arch, layers, size, pattern):
    """The compiled forward (the engine's path) and ``dense_forward``
    against the reference's ``forward(executor="xla")`` and
    ``dense_forward``."""
    r, t = _models(arch, layers, pattern)
    x = _images(arch, size)
    rout, _ = r_forward(r, jnp.asarray(x), executor="xla")
    tout, stats = forward(t, torch.as_tensor(x))
    assert stats == [] and tout.shape == rout.shape
    assert _rel(tout.numpy(), rout) <= 1e-5
    assert _rel(dense_forward(t, torch.as_tensor(x)).numpy(),
                r_dense_forward(r, jnp.asarray(x))) <= 1e-5


@pytest.mark.parametrize("arch,layers,size,pattern", NETS, ids=IDS)
def test_collect_stats_schedule_matches_reference_records(arch, layers,
                                                          size, pattern):
    """``oracle_check``'s per-layer schedule counters equal what the
    reference's layer calls report (``executor="xla"``,
    ``compact_activations=True``, ``report_schedule=True``), and the
    output is within 1e-5 of the dense oracle."""
    r, t = _models(arch, layers, pattern)
    x = _images(arch, size, batch=1)
    out, stats, rel = oracle_check(t, torch.as_tensor(x))
    assert rel <= 1e-5
    xr = jnp.asarray(x)
    for s, layer in zip(stats, r.layers):
        c = layer.conv
        xr, aux = r_conv_layer(xr, c.packed, c.kh, c.kw, c.cout,
                               stride=layer.stride, padding=layer.padding,
                               layout=c.layout, executor="xla",
                               compact_activations=True,
                               report_schedule=True)
        sched = aux["schedule"]
        assert {k: s[k] for k in SCHED_KEYS} == \
            {k: sched[k] for k in SCHED_KEYS}
        assert s["schedule_requests"] == sched["combining"]["requests"]
        assert s["schedule_fetches"] == sched["combining"]["fetches"]
        assert s["spec_oh"] == RS.BENCHMARKS[arch].layers[s["layer"]].oh
        if layer.pool_after is not None:
            xr = r_max_pool(xr, *layer.pool_after)
    assert _rel(out.numpy(), xr) <= 1e-5


def test_resnet50_chunk_pattern_prunes_its_one_tile_layer():
    """Both packages' tile-aligned pruning keeps round(0.421 x 1) = 0 tiles
    of ResNet-50's layer 1 (1x1, 64 -> 64: one 64 x 64 tile), so every map
    after it is zero; the unstructured pattern keeps 42% of each filter."""
    for pattern, kept in (("chunk", 0), ("unstructured", 1)):
        r, t = _models("ResNet50", 4, pattern)
        for net in (r, t):
            assert int((np.asarray(net.layers[1].conv.packed.indices) >= 0)
                       .sum()) == kept
    x = torch.as_tensor(_images("ResNet50", 30, batch=1))
    assert not forward(_models("ResNet50", 4, "chunk")[1], x)[0].any()
    assert forward(_models("ResNet50", 4, "unstructured")[1], x)[0].any()


@pytest.mark.parametrize("arch,layers,size,pattern", [NETS[0], NETS[2]],
                         ids=[IDS[0], IDS[2]])
def test_engine_equals_solo_and_reference_counters(arch, layers, size,
                                                   pattern):
    """``VisionEngine`` outputs bitwise the solo forward, within 1e-5 of
    the reference engine's (``executor="xla"``), and its schedule counters
    equal the reference engine's."""
    r, t = _models(arch, layers, pattern)
    imgs = _images(arch, size, batch=3)
    reqs = [ImageRequest(rid=i, image=imgs[i], arrival=i) for i in range(3)]
    eng = VisionEngine(t, num_slots=2)
    produced = eng.run(reqs)
    reng = RVisionEngine(r, num_slots=2, executor="xla",
                         verify_artifacts=False)
    rprod = reng.run([RImageRequest(q.rid, q.image, q.arrival)
                      for q in reqs])
    solo = compile_forward(t)
    for q in reqs:
        np.testing.assert_array_equal(
            produced[q.rid], solo(torch.as_tensor(q.image[None]))[0].numpy())
        assert _rel(produced[q.rid], rprod[q.rid]) <= 1e-5
    assert eng.schedule_counters() == reng.schedule_counters()


@pytest.mark.parametrize("arch,layers,size,pattern", [
    ("AlexNet", None, 67, "chunk"), ("ResNet18", 4, 32, "unstructured")])
def test_sparse_cnn_sim_row_equals_reference_simulate(arch, layers, size,
                                                      pattern, capsys):
    """``torch_sparse_cnn_sim.main`` on the CPU: its measured densities are
    what the reference's ``measured_densities`` gives on its stats, and its
    Figure-7 row what the reference's ``simulate`` gives at them, over the
    measured layers."""
    argv = ["--bench", arch, "--image-size", str(size), "--pattern",
            pattern, "--device", "cpu"]
    if layers is not None:
        argv += ["--layers", str(layers)]
    res = example("torch_sparse_cnn_sim").main(argv)
    n = res["layers"]
    assert res["rel_err"] <= 1e-5 and len(res["stats"]) == n
    fd, md = r_measured_densities(res["stats"])
    assert (res["filter_density"], res["map_density"]) == (fd, md)
    meas = RS.Benchmark(arch, RS.BENCHMARKS[arch].layers[:n], fd, md)
    dense = RS.simulate(meas, "Dense").cycles
    assert list(res["row"]) == ["One-sided", "SCNN", "SparTen",
                                "SparTen-Iso", "Synchronous", "BARISTA",
                                "Ideal"]
    for scheme, got in res["row"].items():
        ref = RS.simulate(meas, scheme)
        assert got == {"speedup": dense / ref.cycles,
                       "barrier": ref.barrier / max(ref.cycles, 1e-9),
                       "bandwidth": ref.bandwidth / max(ref.cycles, 1e-9)}
    assert res["row"]["BARISTA"]["speedup"] > res["row"]["SparTen"]["speedup"]
    assert f"Figure 7 row ({arch}" in capsys.readouterr().out


def test_quickstart_example_on_cpu():
    """The sparse FFN within 1e-5 of its dense oracle; the speedups are
    the reference cycle model's at the probe's measured map density."""
    res = example("torch_quickstart").main(["--device", "cpu"])
    assert res["rel_err"] <= 1e-5
    assert 0.0 < res["probe"]["scalar"] < 1.0
    bench = RS.Benchmark("quickstart", RS.BENCHMARKS["VGGNet"].layers, 0.35,
                         res["probe"]["scalar"])
    dense = RS.simulate(bench, "Dense").cycles
    assert res["speedups"] == {s: dense / RS.simulate(bench, s).cycles
                               for s in res["speedups"]}


@pytest.mark.parametrize("sparse", [False, True])
def test_serve_batched_example_smoke_on_cpu(sparse):
    """``--smoke`` serves 4 staggered requests on 2 slots and holds each to
    its solo run (it raises otherwise); ``--sparse`` packs every FFN."""
    argv = ["--smoke", "--device", "cpu"] + (["--sparse"] if sparse else [])
    res = example("torch_serve_batched").main(argv)
    assert sorted(res["produced"]) == [0, 1, 2, 3]
    assert all(len(v) == 6 for v in res["produced"].values())
    assert res["tokens"] == 24 and res["prefills"] == 4


def test_train_sparse_lm_example_on_cpu(tmp_path):
    """Four pruned steps with checkpoints every 2 into a ``tmp_path``
    directory, then a restart to 6 that resumes from step 4; the pruned
    weights stay zero throughout (the example raises otherwise)."""
    argv = ["--steps", "4", "--d-model", "64", "--layers", "2", "--seq",
            "16", "--batch", "2", "--ckpt", str(tmp_path), "--ckpt-every",
            "2", "--device", "cpu"]
    mod = example("torch_train_sparse_lm")
    res = mod.main(argv)
    assert res["steps"] == 4 and len(res["losses"]) == 4
    assert res["masked"] == 4 and all(np.isfinite(res["losses"]))
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004"]
    argv[1] = "6"
    again = mod.main(argv)
    assert again["steps"] == 6 and len(again["losses"]) == 2
    assert dataclasses.is_dataclass(mod.ModelConfig)
