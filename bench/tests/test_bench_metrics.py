"""Each metric's arithmetic on a hand-made record and trace summary."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from bench import harness
from bench.reference import chain
from bench.trace import TraceSummary, gaps, union_s
from conftest import tiny_config

BENCH = Path(__file__).resolve().parents[1]
K1 = "void (anonymous namespace)::tile_kernel<float, 8, 128, false, false>"
IM2COL = "void at::native::CatArrayBatchedCopy<float>"
POOL = "void at::native::max_pool_forward_nhwc<float, int>"


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def trace():
    # a 10 s window: two steps' kernels, one copy each way, an idle gap
    dev = [("Memcpy HtoD (Pageable -> Device)", 0.0, 0.5),
           (IM2COL, 0.5, 2.5), (K1, 2.5, 6.5), (POOL, 6.5, 7.0),
           ("Memcpy DtoH (Device -> Pageable)", 7.0, 7.5),
           (K1, 7.25, 8.0)]                     # overlaps the copy
    host = [("bench.step", 0.0, 8.0), ("bench.collect", 8.0, 9.0),
            ("aten::copy_", 8.2, 8.4), ("bench.submit", 9.0, 10.0)]
    return TraceSummary(10.0, dev, host)


def closed_record(**kw):
    cfg = tiny_config()
    steps = [(0.0, 1.0, [0, 1, 2, 3]), (1.0, 2.0, [0, 0, 1, 1])]
    rec = harness.RunRecord("closed", cfg, 12.5, 2.0, 8, steps, 10, 0,
                            traced_steps=steps)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_interval_helpers():
    assert union_s([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert gaps([(1, 2), (1.5, 3)], 0, 5) == [(0, 1), (3, 5)]


def test_trace_summary_busy_ops_and_idle_gaps():
    t = trace()
    assert t.busy_s == pytest.approx(8.0)
    ops = dict(t.device_ops())
    assert ops[K1] == pytest.approx(4.75)
    gaps_by = dict(t.idle_gaps())
    # the 8-10 s gap: its middle, 9.0 s, is where collect ends and submit
    # starts; the innermost (shortest) event holding it is taken
    assert sum(gaps_by.values()) == pytest.approx(2.0)


def test_end_to_end_readers():
    rec = closed_record()
    assert metric("img_per_s")(rec) == pytest.approx(4.0)
    assert metric("setup_s")(rec) == 12.5
    # a record of another kind of loop has nothing for the engine's readers
    other = closed_record(kind="other", trace=trace())
    assert metric("img_per_s")(other) is None
    assert metric("device_idle_share.offline")(other) is None


def test_trace_readers_of_the_engine_cells():
    rec = closed_record(trace=trace())
    assert metric("copy_ms_per_step.offline")(rec) == pytest.approx(
        1.0 / 2 * 1e3)
    assert metric("im2col_share.offline")(rec) == pytest.approx(
        100 * 2.0 / 8.0)
    assert metric("device_idle_share.offline")(rec) == pytest.approx(20.0)
    # without a trace or a card's yardstick there is nothing to read
    bare = closed_record()
    for name in ("copy_ms_per_step.offline", "im2col_share.offline",
                 "k1_roofline.offline", "forward_mfu.offline",
                 "device_idle_share.offline"):
        assert metric(name)(bare) is None


def test_traced_runs_read_host_spans_before_the_profiler():
    peaks = {"float32_flops": 1e9, "hbm_bytes_per_s": 1e12}
    y = harness.Yardstick(np.array([1e9, 2e9, 3e9, 4e9]).astype(np.int64),
                          chain.map_bytes(tiny_config(), 16), 0,
                          peaks)
    rec = closed_record(yardstick=lambda: y, untraced_s=1.0)
    # the first step alone (10e9 MACs) over the first second
    assert metric("forward_mfu.offline")(rec) == pytest.approx(
        100 * 20e9 / 1e9)


def test_roofline_and_mfu_from_the_yardstick():
    peaks = {"float32_flops": 1e9, "hbm_bytes_per_s": 1e12}
    y = harness.Yardstick(np.array([1e9, 2e9, 3e9, 4e9]).astype(np.int64),
                          chain.map_bytes(tiny_config(), 16), 0,
                          peaks)
    rec = closed_record(trace=trace(), yardstick=lambda: y)
    # steps: images 0-3 (10e9 MACs) and 0,0,1,1 (6e9): bounds 20 s and
    # 12 s of compute, over 4.75 s of K1
    assert metric("k1_roofline.offline")(rec) == pytest.approx(
        100 * 32.0 / 4.75)
    # 2 x 16e9 MACs over a 2 s window at 1e9 FLOP/s
    assert metric("forward_mfu.offline")(rec) == pytest.approx(
        100 * 32e9 / (2.0 * 1e9))


def test_every_metric_has_a_reader():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
