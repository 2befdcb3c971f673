"""Port parity, SLA-aware vision serving: the reference's cases
(``tests/test_serve_vision.py``) on the port. ``route_bucket`` and
``fit_image`` against the reference's (padding exact; downscaling within
the stated tolerance); ``VisionServer`` on a ``VirtualClock`` against the
reference's ``VisionServer(executor="xla", verify_artifacts=False)`` on the
same request stream (admission order, bucket and engine steps, SLA misses,
latencies, outputs within 1e-5), the port's outputs bitwise equal to its
solo forward, and the virtual record of ``BENCH_serve_vision.json``."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import vision as rsv
from repro.vision import ImageRequest as RRequest
from repro.vision import build_vision_model as r_build
from repro.vision import model as rvm
from repro_torch.kernels.worklist_core import build_worklist
from repro_torch.serve.vision import (VirtualClock, VisionServer,
                                      WallClock)
from repro_torch.vision import (ImageRequest, VisionEngine,
                                build_vision_model, compile_forward,
                                fit_image, layer_geometry, route_bucket)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
# fit_image's downscale (F.interpolate, antialiased bilinear) against
# jax.image.resize(..., "linear"): the same triangle filter widened by the
# scale. Below 40 px the two agree to 1.2e-7 of the largest value (an fp32
# ulp); from 224 px up they differ by up to 1.0e-5 of it (300 -> 224 px: the
# filter's sample positions are computed in fp32 there), so the tolerance
# is 3e-5 of the largest value
RESIZE_TOL = 3e-5


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=1, seed=0)
    return r_build("VGGNet", **kw), build_vision_model("VGGNet", device=CPU,
                                                       **kw)


@pytest.fixture(scope="module")
def models2():
    kw = dict(num_layers=2, seed=0, pattern="chunk", density=0.4)
    return r_build("VGGNet", **kw), build_vision_model("VGGNet", device=CPU,
                                                       **kw)


def _img(rng, size):
    return np.abs(rng.normal(size=(size, size, 3))).astype(np.float32)


def _req(rng, rid, size, arrival_s=0.0, deadline_s=None):
    return ImageRequest(rid=rid, image=_img(rng, size), arrival_s=arrival_s,
                        deadline_s=deadline_s)


def _pair(models, reqs, **kw):
    """The reference's and the port's server on the same stream."""
    rm, tm = models
    rsrv = rsv.VisionServer(rm, clock=rsv.VirtualClock(), executor="xla",
                            verify_artifacts=False, **kw)
    tsrv = VisionServer(tm, clock=VirtualClock(), **kw)
    rout = rsrv.run([RRequest(r.rid, r.image, arrival_s=r.arrival_s,
                              deadline_s=r.deadline_s) for r in reqs])
    tout = tsrv.run(reqs)
    return rsrv, rout, tsrv, tout


def _same_records(rsrv, tsrv):
    assert {k: vars(v) for k, v in tsrv.records.items()} == \
        {k: vars(v) for k, v in rsrv.records.items()}
    for key in ("engine_steps", "images", "active_lane_steps",
                "idle_lane_steps", "deadlined", "sla_misses",
                "bucket_steps", "latencies_s"):
        assert getattr(tsrv.stats, key) == getattr(rsrv.stats, key), key


# ---------------------------------------------------------------------------
# bucket routing and canonicalization
# ---------------------------------------------------------------------------
def test_route_bucket_equals_reference():
    for buckets in ((8, 16, 24), (16,), (24, 8)):
        for h in range(1, 30, 3):
            for w in (1, 7, 16, 25, 40):
                assert route_bucket(buckets, h, w) == \
                    rvm.route_bucket(buckets, h, w)
    with pytest.raises(ValueError):
        route_bucket((), 4, 4)


def test_fit_image_pads_exactly(rng):
    for h, w in ((10, 10), (16, 5), (1, 16)):
        img = np.abs(rng.normal(size=(h, w, 3))).astype(np.float32)
        got = fit_image(img, 16)
        np.testing.assert_array_equal(got, rvm.fit_image(img, 16))
        np.testing.assert_array_equal(got[:h, :w], img)
        assert got.shape == (16, 16, 3) and got.dtype == np.float32


@pytest.mark.parametrize("h,w,size", [(20, 20, 16), (25, 17, 16),
                                      (33, 40, 8), (224, 300, 224),
                                      (17, 16, 16)])
def test_fit_image_downscale_within_tolerance(rng, h, w, size):
    img = np.abs(rng.normal(size=(h, w, 3))).astype(np.float32)
    got = fit_image(img, size)
    ref = rvm.fit_image(img, size)
    assert got.shape == ref.shape == (size, size, 3)
    assert np.abs(got - ref).max() <= RESIZE_TOL * np.abs(ref).max()
    with pytest.raises(ValueError):
        fit_image(img[..., 0], size)


def test_layer_geometry_matches_cached_work_lists(models2):
    _, tm = models2
    srv = VisionServer(tm, num_slots=2, buckets=(16,), clock=VirtualClock(),
                       step_cost_s=0.1)
    srv.warmup()
    for layer, g in zip(tm.layers, layer_geometry(tm, 16)):
        assert 2 * g["mb_per_img"] in layer.conv.wl_cache
    assert srv.stats.compile_s > 0


def test_virtual_clock_requires_step_cost(models):
    with pytest.raises(ValueError):
        VisionServer(models[1], buckets=(8,), clock=VirtualClock())
    with pytest.raises(ValueError):
        VisionServer(models[1], buckets=(8, 16), clock=VirtualClock(),
                     step_cost_s={8: 1.0})


def test_unported_options_raise(models):
    """The mesh is ported (``tests/test_torch_dist_vision.py``): what is
    not a mesh (no dim names) is refused; the artifact verifier is ported
    and on by default (``tests/test_torch_analysis.py``): a clean model is
    admitted."""
    VisionServer(models[1], buckets=(8,), step_cost_s=1.0,
                 clock=VirtualClock(), verify_artifacts=True)
    with pytest.raises(ValueError, match="dim names"):
        VisionServer(models[1], buckets=(8,), step_cost_s=1.0,
                     clock=VirtualClock(), mesh=object())


# ---------------------------------------------------------------------------
# admission and SLA accounting against the reference (virtual clock)
# ---------------------------------------------------------------------------
def test_overload_sla_miss_accounting_equals_reference(rng, models):
    reqs = [_req(rng, i, 8, arrival_s=0.0, deadline_s=1.0) for i in range(6)]
    rsrv, _, tsrv, _ = _pair(models, reqs, num_slots=2, buckets=(8,),
                             step_cost_s=1.0)
    _same_records(rsrv, tsrv)
    assert tsrv.stats.sla_misses == 4
    assert tsrv.stats.sla_miss_rate == pytest.approx(4 / 6)
    assert [tsrv.records[i].done_s for i in range(6)] == \
        [1.0, 1.0, 2.0, 2.0, 3.0, 3.0]


def test_staggered_arrivals_idle_between(rng, models):
    reqs = [_req(rng, i, 8, arrival_s=2.0 * i, deadline_s=2.0 * i + 1.5)
            for i in range(3)]
    rsrv, _, tsrv, _ = _pair(models, reqs, num_slots=2, buckets=(8,),
                             step_cost_s=1.0)
    _same_records(rsrv, tsrv)
    assert tsrv.stats.sla_misses == 0
    assert [tsrv.records[i].latency_s for i in range(3)] == [1.0] * 3


@pytest.mark.parametrize("deadline", [1.5, None])
def test_admission_yields_to_urgent_bucket(rng, models, deadline):
    """With the deadline the urgent small bucket goes first; without it,
    throughput-max runs the fuller bucket first — as the reference."""
    reqs = [_req(rng, 0, 16), _req(rng, 1, 16),
            _req(rng, 2, 8, deadline_s=deadline)]
    rsrv, _, tsrv, _ = _pair(models, reqs, num_slots=2, buckets=(8, 16),
                             step_cost_s={8: 1.0, 16: 1.0})
    _same_records(rsrv, tsrv)
    assert tsrv.records[2].done_s == (1.0 if deadline else 2.0)


def test_round_robin_fallback_when_unconstrained(rng, models):
    reqs = [_req(rng, 0, 8), _req(rng, 1, 8), _req(rng, 2, 16),
            _req(rng, 3, 16)]
    rsrv, _, tsrv, _ = _pair(models, reqs, num_slots=1, buckets=(8, 16),
                             step_cost_s={8: 1.0, 16: 1.0})
    _same_records(rsrv, tsrv)
    order = sorted(tsrv.records.values(), key=lambda r: r.done_s)
    assert [r.bucket for r in order] == [8, 16, 8, 16]


def test_best_effort_and_default_sla(rng, models):
    reqs = [_req(rng, i, 8) for i in range(3)]
    rsrv, _, tsrv, _ = _pair(models, reqs, num_slots=1, buckets=(8,),
                             step_cost_s=5.0)
    _same_records(rsrv, tsrv)
    assert tsrv.stats.deadlined == 0 and tsrv.stats.sla_miss_rate == 0.0
    rsrv, _, tsrv, _ = _pair(models, reqs[:2], num_slots=1, buckets=(8,),
                             step_cost_s=1.0, default_sla_s=1.5)
    _same_records(rsrv, tsrv)
    assert tsrv.stats.deadlined == 2 and tsrv.stats.sla_misses == 1


# ---------------------------------------------------------------------------
# outputs: the reference's within 1e-5, the port's solo forward bitwise
# ---------------------------------------------------------------------------
def test_mixed_buckets_match_reference_and_solo(rng, models2):
    sizes = (10, 16, 5, 20, 8, 7)
    reqs = [_req(rng, i, s, arrival_s=0.01 * i, deadline_s=0.01 * i + 0.5)
            for i, s in enumerate(sizes)]
    rsrv, rout, tsrv, tout = _pair(models2, reqs, num_slots=2,
                                   buckets=(8, 16), step_cost_s=0.1)
    _same_records(rsrv, tsrv)
    fwd = compile_forward(models2[1])
    for r in reqs:
        ref = np.asarray(rout[r.rid])
        assert np.abs(tout[r.rid] - ref).max() <= 1e-5 * np.abs(ref).max()
        canon = fit_image(r.image, route_bucket(tsrv.buckets,
                                                *r.image.shape[:2]))
        one = fwd(torch.as_tensor(canon[None]))[0].numpy()
        assert np.array_equal(tout[r.rid], one)


def test_batched_equals_sequential_bitwise(rng, models):
    reqs = [_req(rng, i, s) for i, s in enumerate((8, 6, 8, 7))]
    batched = VisionServer(models[1], num_slots=4, buckets=(8,),
                           clock=VirtualClock(), step_cost_s=1.0)
    out_b = batched.run(reqs)
    assert batched.stats.engine_steps == 1
    solo = VisionServer(models[1], num_slots=1, buckets=(8,),
                        clock=VirtualClock(), step_cost_s=1.0)
    out_s = solo.run([ImageRequest(r.rid, r.image) for r in reqs])
    assert solo.stats.engine_steps == 4
    for r in reqs:
        assert np.array_equal(out_b[r.rid], out_s[r.rid])


# ---------------------------------------------------------------------------
# cross-request telescoped schedule counters, and the bench's record
# ---------------------------------------------------------------------------
def _poisson_requests(rng, n, buckets, mean_gap_s, sla_s):
    """``benchmarks/serve_vision_bench.py``'s open-loop trace."""
    t = 0.0
    reqs = []
    sizes = sorted({s for b in buckets for s in (b - 2, b, b + 1)})
    for i in range(n):
        t += float(rng.exponential(mean_gap_s))
        size = int(sizes[rng.integers(len(sizes))])
        img = np.abs(rng.normal(size=(size, size, 3))).astype(np.float32)
        reqs.append(ImageRequest(rid=i, image=img, arrival_s=t,
                                 deadline_s=t + sla_s))
    return reqs


def test_bench_serve_vision_virtual_record_reproduced(models2):
    """``BENCH_serve_vision.json`` at its settings (VGG 2-layer head, chunk
    pattern, density 0.4, buckets 8/16, 4 slots, 8 Poisson requests, mean
    gap 0.03 s, SLA 0.2 s, seed 0, the bench's step costs): the port's
    virtual record, and the served batch's cross-request combine factor."""
    bench = json.loads((ROOT / "BENCH_serve_vision.json").read_text())
    assert bench["slots"] == 4 and bench["requests"] == 8
    reqs = _poisson_requests(np.random.default_rng(bench["seed"]),
                             bench["requests"], tuple(bench["buckets"]),
                             bench["mean_gap_s"], bench["sla_s"])
    srv = VisionServer(models2[1], num_slots=bench["slots"],
                       buckets=tuple(bench["buckets"]), clock=VirtualClock(),
                       step_cost_s={8: 0.02, 16: 0.05})
    srv.run(reqs)
    st = srv.stats
    got = {"images": st.images, "engine_steps": st.engine_steps,
           "deadlined": st.deadlined, "sla_misses": st.sla_misses,
           "sla_miss_rate": round(st.sla_miss_rate, 6),
           "slot_utilization": round(st.slot_utilization, 6),
           "bucket_steps": {str(k): v for k, v in
                            sorted(st.bucket_steps.items())}}
    assert got == bench["virtual"]
    rec = srv.schedule_counters()
    assert rec["cross_request_combine_factor"] == pytest.approx(4.0)
    for key, want in bench["schedule"].items():
        assert rec[key] == pytest.approx(want), key


def test_server_schedule_counters_surface_cross_factor(rng, models2):
    srv = VisionServer(models2[1], num_slots=4, buckets=(8, 16),
                       clock=VirtualClock(), step_cost_s=0.1)
    assert srv.schedule_counters() is None
    srv.run([_req(rng, i, 8 + 8 * (i % 2)) for i in range(8)])
    rec = srv.schedule_counters()
    assert rec["cross_request_combine_factor"] == pytest.approx(4.0)
    assert set(rec["per_bucket"]) == {"8", "16"}
    for layer, g in zip(models2[1].layers, layer_geometry(models2[1], 16)):
        wl = build_worklist(layer.conv.packed.host_indices(),
                            4 * g["mb_per_img"], mb_per_img=g["mb_per_img"])
        assert wl.combined().cross_request_combine_factor == \
            pytest.approx(4.0)


def test_engine_and_server_take_arrival_and_deadline(rng, models):
    req = _req(rng, 0, 8, arrival_s=0.5, deadline_s=2.0)
    assert (req.arrival, req.arrival_s, req.deadline_s) == (0, 0.5, 2.0)
    eng = VisionEngine(models[1], num_slots=1)
    out = eng.run([req])
    assert out[0].shape == (8, 8, 64)


def test_wallclock_run_reports_percentiles(rng, models):
    srv = VisionServer(models[1], num_slots=2, buckets=(8,),
                       clock=WallClock())
    srv.run([_req(rng, i, 8, arrival_s=0.01 * i) for i in range(4)])
    assert srv.stats.images == 4
    p = srv.stats.latency_percentiles()
    assert 0 < p["p50"] <= p["p95"] <= p["p99"]
    assert srv.stats.img_per_s > 0 and srv.stats.wall_s > 0
    assert srv.stats.compile_s > 0
