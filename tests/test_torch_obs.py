"""Program spans (``repro_torch.obs``) on the CPU: the phases of a
``VisionEngine`` and a ``VisionServer`` step as the profiler records them,
the one-off spans of a new batch shape, outputs unchanged under the
profiler, and no ``record_function`` entered while none records."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.serve import VirtualClock, VisionServer
from repro_torch.vision import ImageRequest, VisionEngine, build_vision_model

SIZE = 16
PHASES = ("engine.admit", "engine.assemble", "engine.forward",
          "engine.copy_out", "engine.retire")
PREFIXES = ("engine.", "server.", "graph.", "conv.")


def _model():
    return build_vision_model("VGGNet", num_layers=2, pattern="chunk",
                              density=0.4, seed=0, device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


def _requests(n, first=0):
    rng = np.random.default_rng(first)
    return [ImageRequest(first + i, np.abs(rng.normal(
        size=(SIZE, SIZE, 3))).astype(np.float32)) for i in range(n)]


def _recorded(fn):
    """``fn()`` under a CPU profiler: its result and the program's spans,
    (name, start ns, end ns) in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PREFIXES)]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(spans, outer):
    return [s for s in spans
            if s is not outer and outer[1] <= s[1] and s[2] <= outer[2]]


def _steps(engine, n):
    for _ in range(n):
        assert engine.step()


def test_engine_step_holds_its_phases_in_order(model):
    eng = VisionEngine(model, num_slots=2)
    for r in _requests(4):
        eng.submit(r)
    _, spans = _recorded(lambda: _steps(eng, 2))
    steps = [s for s in spans if s[0] == "engine.step"]
    assert len(steps) == 2
    for step in steps:
        inner = _inside(spans, step)
        assert tuple(s[0] for s in inner if s[0] in PHASES) == PHASES
        # the phases follow one another
        ph = [s for s in inner if s[0] in PHASES]
        assert all(a[2] <= b[1] for a, b in zip(ph, ph[1:]))


def test_warmup_and_worklist_builds_on_a_new_batch_shape_only():
    """Each engine warms its batch shape on its first step; the layers
    build a work list only for a row-block count they have not seen."""
    model = _model()
    for slots in (2, 3):          # a fresh batch width for the model
        eng = VisionEngine(model, num_slots=slots)
        for r in _requests(2 * slots):
            eng.submit(r)
        _, spans = _recorded(lambda: _steps(eng, 2))
        first, second = [s for s in spans if s[0] == "engine.step"]
        names = [s[0] for s in _inside(spans, first)]
        assert names.count("engine.warmup") == 1
        warm, = [s for s in spans if s[0] == "engine.warmup"]
        builds = [s for s in spans if s[0] == "conv.worklist_build"]
        assert len(builds) == model.num_layers
        assert all(s in _inside(spans, warm) for s in builds)
        assert not {"engine.warmup", "conv.worklist_build"} & {
            s[0] for s in _inside(spans, second)}


def test_outputs_bitwise_the_same_under_the_profiler(model):
    reqs = _requests(5, first=10)
    plain = VisionEngine(model, num_slots=2).run(reqs)
    traced, spans = _recorded(
        lambda: VisionEngine(model, num_slots=2).run(reqs))
    # three steps, then the tick that finds the engine idle
    assert sum(s[0] == "engine.step" for s in spans) == 4
    assert sorted(plain) == sorted(traced)
    assert all(np.array_equal(plain[r], traced[r]) for r in plain)


def test_server_step_holds_its_phases_in_order(model):
    srv = VisionServer(model, num_slots=2, buckets=(SIZE,),
                       clock=VirtualClock(), step_cost_s=0.01)
    for r in _requests(3):
        srv.submit(r)
    srv.warmup()
    _, spans = _recorded(lambda: [srv.step(), srv.step()])
    want = ("server.select", "server.assemble", "server.copy_out",
            "server.retire")
    # two events, each its four phases in turn, one after another
    got = [s for s in spans if s[0].startswith("server.")]
    assert tuple(s[0] for s in got) == want * 2
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))


def test_no_record_function_while_no_profiler_records(model, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert obs.span("engine.step") is obs.span("graph.copy_in")
    with obs.span("engine.step") as inner:
        assert inner is None
    eng = VisionEngine(model, num_slots=2)
    got = eng.run(_requests(3, first=20))
    assert sorted(got) == [20, 21, 22]
    srv = VisionServer(model, num_slots=2, buckets=(SIZE,),
                       clock=VirtualClock(), step_cost_s=0.01)
    assert sorted(srv.run(_requests(3, first=30))) == [30, 31, 32]
