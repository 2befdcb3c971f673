"""The readers of the program's spans on a hand-made trace summary."""
import pytest

from bench.trace import TraceSummary
from test_bench_metrics import closed_record, metric

K1 = "void (anonymous namespace)::tile_kernel<float, 8, 128, false, false>"
NAMES = ("engine_host_ms_per_step.offline",
         "copy_in_host_ms_per_step.offline",
         "host_bound_idle_share.offline")


def trace():
    """A 10 s stretch: a step clipped by its start, two whole steps, a step
    clipped by its end, each with the engine's phases and the graph's."""
    host = [("bench.step", 0.0, 2.0), ("engine.step", 0.0, 2.0),
            ("engine.retire", 1.5, 2.0)]
    for s, admit, assemble, copy_in, fwd, copy_out, end in (
            (2.0, 2.5, 3.5, 3.8, 4.0, 4.5, 5.0),
            (5.0, 5.2, 6.0, 6.6, 7.0, 8.0, 9.0)):
        host += [("bench.step", s, end), ("engine.step", s, end),
                 ("engine.admit", s, admit),
                 ("engine.assemble", admit, assemble),
                 ("engine.forward", assemble, fwd),
                 ("graph.copy_in", assemble, copy_in),
                 ("aten::copy_", assemble, copy_in),
                 ("graph.replay", copy_in, copy_in + 0.1),
                 ("engine.copy_out", fwd, copy_out),
                 ("engine.retire", copy_out, end)]
    host += [("bench.collect", 9.0, 9.5), ("bench.step", 9.5, 10.0),
             ("engine.step", 9.5, 10.0), ("engine.admit", 9.5, 10.0)]
    dev = [("Memcpy HtoD (Pageable -> Device)", 3.6, 3.8), (K1, 3.9, 4.2),
           ("Memcpy DtoH (Device -> Pageable)", 4.2, 4.4),
           ("Memcpy HtoD (Pageable -> Device)", 6.3, 6.6), (K1, 6.7, 7.5),
           ("Memcpy DtoH (Device -> Pageable)", 7.5, 7.8)]
    return TraceSummary(10.0, dev, host)


def test_per_step_readers_leave_the_clipped_steps_out():
    rec = closed_record(trace=trace())
    # admit + assemble + retire: 0.5 + 1.0 + 0.5 and 0.2 + 0.8 + 1.0 s;
    # the edge steps' retire (0.5 s) and admit (0.5 s) are not counted
    assert metric("engine_host_ms_per_step.offline")(rec) == pytest.approx(
        (2.0 + 2.0) / 2 * 1e3)
    assert metric("copy_in_host_ms_per_step.offline")(rec) == pytest.approx(
        (0.3 + 0.6) / 2 * 1e3)


def test_idle_share_by_overlap_not_midpoint():
    t = trace()
    # idle: 0-3.6, 3.8-3.9, 4.4-6.3, 6.6-6.7, 7.8-10; inside the host
    # phases of it: 0.5 + 0.5 + 1.0 + 0.1, 0, 0.5 + 0.2 + 0.8 + 0.3, 0,
    # 1.0 + 0.5 (the edge steps' phases count: they are of the stretch)
    share = metric("host_bound_idle_share.offline")(closed_record(trace=t))
    assert share == pytest.approx(100 * 5.4 / 10.0)
    # a gap named by its middle would count whole gaps: 3.6 + 1.9 + 2.2 s
    by_mid = dict(t.idle_gaps())
    assert sum(by_mid.get(n, 0.0) for n in (
        "engine.admit", "engine.assemble", "engine.retire",
        "graph.copy_in")) == pytest.approx(7.7)


def test_nothing_to_read_without_the_programs_steps():
    t = trace()
    older = TraceSummary(t.window_s, t.device,
                         [h for h in t.host if h[0].startswith(("bench.",
                                                                "aten::"))])
    for name in NAMES:
        assert metric(name)(closed_record(trace=older)) is None
        assert metric(name)(closed_record()) is None
        assert metric(name)(closed_record(kind="other", trace=t)) is None
    # one step, clipped by both edges: no whole step to divide by
    edge = TraceSummary(2.0, [(K1, 0.5, 1.0)],
                        [("engine.step", 0.0, 2.0),
                         ("engine.assemble", 0.0, 0.5)])
    rec = closed_record(trace=edge)
    assert metric("engine_host_ms_per_step.offline")(rec) is None
    assert metric("copy_in_host_ms_per_step.offline")(rec) is None
    assert metric("host_bound_idle_share.offline")(rec) == pytest.approx(
        100 * 0.5 / 2.0)
