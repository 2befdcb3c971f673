"""Port parity, the mesh-sharded vision runtime on gloo worlds of CPU
ranks (the legs of ``tests/test_dist_vision.py``'s script, each rank one
process; ``tests/torch_dist_world.py`` runs them).

One module-scoped fixture runs an 8-rank world under its own timeout; each
test reads one leg's record from every rank: the data-parallel forward on
8, 4 and 2 ranks bitwise equal to the port's solo forward and within 1e-5
of the reference's ``compile_forward(executor="xla")``; ``cout_sharded_spmm``
on 2, 4 and 8 ranks with its occupancy bitwise equal to the port's whole
walk and within 1e-5 of the reference's ``worklist_spmm(executor="xla")``;
``VisionEngine(mesh=)`` and its per-device counters; ``mesh_schedule_
counters``; the elastic re-plan onto 4 of 8 ranks; ``VisionServer(mesh=)``;
the collective matmuls; ``hierarchical_psum`` on (pod=2, data=4); the
refusals. Without a world: the structural record of
``BENCH_dist_vision.json``. The launcher runs with ``--mesh 2`` on two CPU
ranks under ``torch.distributed.run`` and with ``--mesh 1`` alone."""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist  # noqa: F401  (installs the jax.shard_map shim)
from jax.sharding import PartitionSpec as JP
from repro.dist import elastic as r_el
from repro.dist.compression import hierarchical_psum as r_hpsum
from repro.kernels import worklist_core as r_wc
from repro.serve import vision as r_sv
from repro.vision import ImageRequest as RRequest
from repro.vision import model as r_vm
from repro.vision.mesh import mesh_schedule_counters as r_mesh_counters
from repro_torch.dist.collective_matmul import exchange_overlap_fraction
from repro_torch.kernels.worklist_core import (SHARD_BALANCE_TOL,
                                               build_worklist,
                                               per_shard_steps,
                                               shard_imbalance,
                                               shard_scaling_efficiency)
from repro_torch.sparsity.conv import build_sparse_chain
from repro_torch.vision import build_vision_model, layer_geometry

import torch_dist_world as W

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
WORLD_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's leg records of one 8-rank gloo world."""
    out = tmp_path_factory.mktemp("world")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_world.py"),
                        str(out), str(WORLD)], env=env, capture_output=True,
                       text=True, timeout=WORLD_TIMEOUT_S)
    recs = {}
    for rank in range(WORLD):
        path = out / f"rank{rank}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                recs[rank] = pickle.load(f)
    return r, recs


def _leg(world, name, ranks=range(WORLD)):
    """The leg's results by rank, after requiring it passed on each."""
    r, recs = world
    got = {}
    for rank in ranks:
        assert rank in recs, f"rank {rank} left no record:\n{r.stderr[-3000:]}"
        status, val = recs[rank].get(name, ("missing", r.stderr[-3000:]))
        assert status == "ok", f"rank {rank} leg {name}: {val}"
        got[rank] = val
    return got


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def ref_model():
    return r_vm.build_vision_model("VGGNet", **W.MODEL)


def test_world_ran_to_its_end(world):
    r, recs = world
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert sorted(recs) == list(range(WORLD))


def test_data_parallel_forward_bitwise_solo_and_reference(world, ref_model):
    got = _leg(world, "data_parallel")
    ref = np.asarray(r_vm.compile_forward(ref_model, executor="xla")(
        jnp.asarray(W.inputs())))
    for rank, outs in got.items():
        # every rank of each mesh returned the whole batch
        want = [n for n in (8, 4, 2) if rank < n]
        assert sorted(outs) == sorted(want), (rank, sorted(outs))
        for n, out in outs.items():
            assert np.array_equal(out, got[0][8]), (rank, n)
    assert got[0][8].shape == ref.shape
    assert _rel(got[0][8], ref) <= 1e-5


@pytest.mark.parametrize("d", [2, 4, 8])
def test_cout_sharded_ring_bitwise_and_reference(world, d):
    got = _leg(world, "cout_sharded")
    idx, assign, mb, patches, vals, bk, bn, bm = W.cout_case(d)
    rwl = r_wc.build_worklist(idx, mb, shard_of=assign)
    ref = np.asarray(r_wc.worklist_spmm(
        jnp.asarray(patches), jnp.asarray(vals), rwl, bk=bk, bn=bn,
        bm_rows=bm, executor="xla")[0])
    ref_occ = (np.abs(ref).reshape(mb, bm, rwl.nb, bn).max(axis=(1, 3))
               > 0).astype(np.int32)
    for rank in range(d):
        full, occ = got[rank][d]
        assert np.array_equal(full, got[0][d][0])
        assert _rel(full, ref) <= 1e-5
        assert np.array_equal(occ, ref_occ)
    assert ref_occ.min() == 0 and ref_occ.max() == 1


def test_mesh_engine_counters_match_the_reference(world, ref_model):
    got = _leg(world, "engine")
    # the reference's expectation: each device walks the local width's
    # (num_slots / D = 1 image) work lists, the same on every device
    geo = r_vm.layer_geometry(ref_model, W.SIZE)
    local = sum(r_wc.build_worklist(l.conv.packed.host_indices(),
                                    g["mb_per_img"]).num_steps
                for l, g in zip(ref_model.layers, geo))
    for rec in got.values():
        sc = rec["counters"]
        assert sc["num_devices"] == WORLD
        assert sc["per_device_steps"] == [local] * WORLD
        assert sc["step_imbalance"] == 0.0
        assert sc["step_scaling_efficiency"] == 1.0
        assert sc["scheduled_steps"] == local
    ref = np.asarray(r_vm.compile_forward(ref_model, executor="xla")(
        jnp.asarray(W.inputs()[:1])))
    assert _rel(got[0]["out0"], ref[0]) <= 1e-5


def test_mesh_schedule_counters_equal_to_reference(world):
    got = _leg(world, "engine")
    # a rank's model cached the widths the legs before it ran there: the
    # solo batch of 8 and the local widths of the meshes of 8, 4 and 2
    # ranks it belongs to (1, 2 and 4 images)
    x = jnp.asarray(W.inputs())
    for widths in ((8, 1, 2, 4), (8, 1, 2), (8, 1)):
        ref_model = r_vm.build_vision_model("VGGNet", **W.MODEL)
        for b in widths:
            r_vm.compile_forward(ref_model, executor="xla")(x[:b])
        want = r_mesh_counters(ref_model, WORLD)
        ranks = [r for r in got if [8, 1] + [2] * (r < 4) + [4] * (r < 2)
                 == list(widths)]
        assert ranks
        for rank in ranks:
            assert got[rank]["mesh_counters"] == want, rank


def test_elastic_replan_serves_on_the_smaller_mesh(world):
    got = _leg(world, "elastic")
    sim = r_el.FailureSimulator(fail_at={3: 1, 5: 3})
    plan = r_el.plan_mesh(sim.surviving(5, WORLD), model_parallel=1,
                          pod_size=WORLD)
    for rank, rec in got.items():
        p = rec["plan"]
        assert (p.pod, p.data, p.model) == (plan.pod, plan.data, plan.model)
        assert rec["member"] == (rank < plan.data)
        if rec["member"]:
            assert rec["counters"]["num_devices"] == plan.data


def test_mesh_server_matches_the_reference(world, ref_model):
    got = _leg(world, "server")
    rng = np.random.default_rng(3)
    reqs = [RRequest(i, rng.standard_normal((s, s, 3)).astype(np.float32),
                     arrival_s=0.001 * i, deadline_s=1.0 + 0.001 * i)
            for i, s in enumerate([20, 24, 30, 18, 32, 24, 12, 28, 24, 31])]
    cost = {24: 0.01, 32: 0.02}

    def serve(slots):
        srv = r_sv.VisionServer(ref_model, num_slots=slots, buckets=(24, 32),
                                clock=r_sv.VirtualClock(), step_cost_s=cost,
                                executor="xla", verify_artifacts=False)
        srv.run(reqs)
        return srv
    whole, local = serve(W.BATCH), serve(W.BATCH // WORLD)
    per_local = local.schedule_counters()["per_bucket"]
    for rec in got.values():
        assert rec["steps"] == whole.stats.engine_steps
        assert rec["sla_misses"] == whole.stats.sla_misses
        assert rec["buckets"] == {r: whole.records[r].bucket
                                  for r in whole.records}
        sc = rec["counters"]
        assert sc["num_devices"] == WORLD
        assert sorted(sc["per_bucket"]) == sorted(
            f"dev{d}/{b}" for d in range(WORLD) for b in (24, 32))
        for key, rb in sc["per_bucket"].items():
            assert rb == per_local[key.split("/")[1]], key
        for k in ("scheduled_steps", "combined_filter_fetches"):
            assert sc[k] == WORLD * sum(r[k] for r in per_local.values())


def test_collective_matmuls_match_the_product(world):
    got = _leg(world, "collective_matmul")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    for rec in got.values():
        np.testing.assert_allclose(rec["allgather"], x @ w, rtol=1e-5,
                                   atol=1e-4)
    scattered = np.concatenate([got[r]["reducescatter"]
                                for r in range(WORLD)], axis=1)
    np.testing.assert_allclose(scattered, x @ w, rtol=1e-5, atol=1e-4)


def test_hierarchical_psum_and_its_stats_match_the_reference(world):
    got = _leg(world, "hierarchical_psum")
    # the reference's stats for the same per-rank leaf, under a 1x1 mesh
    stats = {}

    def body(g):
        r, s = r_hpsum(g)
        stats.update(s)
        return r
    fn = jax.shard_map(body, mesh=jax.make_mesh((1, 1), ("pod", "data")),
                       in_specs=JP(("pod", "data"), None),
                       out_specs=JP(("pod", "data"), None), check_vma=False)
    fn(np.zeros((1, 16), np.float32))
    mean = np.arange(WORLD, dtype=np.float32).mean()
    for rec in got.values():
        assert rec["member"]
        assert np.all(rec["out"] == mean)
        assert rec["stats"] == stats


def test_refusals(world):
    _leg(world, "refusals")


# ---------------------------------------------------------------------------
# BENCH_dist_vision.json's structural record (no world)
# ---------------------------------------------------------------------------
def _device_steps(model, size, batch, d):
    geo = layer_geometry(model, size)
    local = batch // d
    return sum(build_worklist(layer.conv.packed.host_indices(),
                              local * g["mb_per_img"]).num_steps
               for layer, g in zip(model.layers, geo))


def test_bench_dist_vision_structural_record():
    bench = json.loads((ROOT / "BENCH_dist_vision.json").read_text())
    cpu = torch.device("cpu")
    for arch, key, kw in (
            ("VGGNet", "scaling",
             dict(mesh_devices=max(bench["devices"]))),
            ("ResNet50", "resnet50_scaling", {})):
        model = build_vision_model(arch, seed=bench["seed"],
                                   pattern=bench["pattern"],
                                   density=bench["density"], device=cpu,
                                   num_layers=bench["num_layers"]
                                   if arch == "VGGNet" else None, **kw)
        base = None
        for d in bench["devices"]:
            rec = bench[key][str(d)]
            steps = _device_steps(model, bench["image_size"],
                                  bench["batch"], d)
            base = steps if base is None else base
            assert steps == rec["per_device_steps"], (arch, d)
            assert steps * d == rec["total_steps"]
            assert round(base / steps, 4) == rec["device_step_speedup"]
            assert round(base / steps / d, 4) == \
                rec["step_scaling_efficiency"]

    sb = bench["shard_balance"]
    rng = np.random.default_rng(bench["seed"])
    ws = [np.asarray(rng.normal(size=(3, 3, 64, 1024)), np.float32),
          np.asarray(rng.normal(size=(3, 3, 1024, 1024)), np.float32),
          np.asarray(rng.normal(size=(3, 3, 1024, 1024)), np.float32)]
    chain = build_sparse_chain(ws, density=0.35, pattern="chunk",
                               mesh_devices=sb["mesh_devices"], device=cpu)
    agg = np.zeros(sb["mesh_devices"], np.int64)
    max_walk = 0
    for i, pc in enumerate(chain):
        wl = build_worklist(pc.packed.host_indices(), 1,
                            shard_of=pc.packed.shard_of)
        per = per_shard_steps(wl, num_shards=pc.shard.num_devices)
        want = sb["per_layer"][str(i)]
        assert pc.shard.mode == want["mode"]
        assert [int(c) for c in per] == want["device_steps"]
        assert round(shard_imbalance(per), 6) == want["imbalance"]
        assert round(shard_scaling_efficiency(per), 6) == \
            want["scaling_efficiency"]
        agg += per
        max_walk = max(max_walk, int(per.max()))
    assert [int(c) for c in agg] == sb["chain_device_steps"]
    assert round(shard_imbalance(agg), 6) == sb["chain_imbalance"]
    assert round(shard_scaling_efficiency(agg), 6) == \
        sb["chain_scaling_efficiency"]
    assert sb["tolerance"] == SHARD_BALANCE_TOL
    assert round(exchange_overlap_fraction(max_walk, sb["mesh_devices"]),
                 6) == sb["exchange_overlap_fraction"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
LAUNCH = ["-m", "repro_torch.launch.vision", "--smoke", "--device", "cpu",
          "--pattern", "chunk", "--slots", "2", "--requests", "4"]


def _launch(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.run([sys.executable] + args, env=env,
                          capture_output=True, text=True, timeout=240)


def test_launcher_mesh_two_cpu_ranks():
    r = _launch(["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "2"] + LAUNCH + ["--mesh", "2"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("mesh: 2 devices, per-device steps") == 2
    assert r.stdout.count("engine output matches solo forward") == 2


def test_launcher_mesh_one_rank_in_process():
    r = _launch(LAUNCH + ["--mesh", "1"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "mesh: 1 devices, per-device steps" in r.stdout
    with pytest.raises(subprocess.CalledProcessError):
        subprocess.run([sys.executable] + LAUNCH + ["--mesh", "2"],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=240,
                       check=True)
