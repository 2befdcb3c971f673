"""A gloo world of CPU ranks that runs the port's mesh legs, for
``tests/test_torch_dist_vision.py``.

    python tests/torch_dist_world.py OUT_DIR [WORLD]

Spawns ``WORLD`` ranks (default 8; one process each, one torch thread,
a ``file://`` store in ``OUT_DIR``) that run every leg of :data:`LEGS` in
turn. Each rank records, per leg, ``"ok"`` or the traceback, and the
arrays the parent compares with the reference, in ``OUT_DIR/rank<r>.pkl``.
The parent runs this under its own timeout; a rank that hangs in a
collective gives up after the process group's timeout.

Imports the port only (no JAX): the reference's numbers are computed by
the test process. :func:`inputs` and :func:`cout_case` make the inputs the
same way there.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

MODEL = dict(num_layers=3, pattern="chunk", density=0.4, mesh_devices=4)
BATCH = 8
SIZE = 24
GROUP_TIMEOUT_S = 120


def inputs() -> np.ndarray:
    """The reference test's 8 blob images at 24 px (seed 0)."""
    rng = np.random.default_rng(0)
    x = np.zeros((BATCH, SIZE, SIZE, 3), np.float32)
    dense = rng.standard_normal((BATCH, SIZE, SIZE, 3))
    x[:] = np.where(rng.random((BATCH, SIZE, SIZE, 3)) < 0.5, dense, 0.0)
    return x


def cout_case(devices: int, seed: int = 1):
    """One cout-sharded layer's operands, packed for ``devices`` clusters
    as the reference test packs them: ``(idx, assign, mb, patches, vals,
    bk, bn, bm_rows)`` with the row blocks grouped by device."""
    from repro_torch.sparsity.conv import mesh_shard_assignment
    rng = np.random.default_rng(seed)
    nb, kb, max_nz, mb = 8, 6, 4, 2
    idx = np.full((nb, max_nz), -1, np.int32)
    for n in range(nb):
        k = rng.integers(1, max_nz + 1)
        idx[n, :k] = np.sort(rng.choice(kb, size=k, replace=False))
    steps = np.maximum((idx >= 0).sum(1), 1).astype(np.int64)
    assign, _ = mesh_shard_assignment(steps, devices)
    order = np.argsort(assign, kind="stable")
    idx, assign = idx[order], assign[order]
    bk, bn, bm_rows = 8, 16, 4
    patches = rng.standard_normal((bm_rows * mb, kb * bk)).astype(np.float32)
    patches[:bm_rows, :bk] = 0.0                 # a dead tile: occupancy 0
    vals = rng.standard_normal((nb, max_nz, bk, bn)).astype(np.float32)
    return idx, assign, mb, patches, vals, bk, bn, bm_rows


def requests(n: int, start: int = 0):
    from repro_torch.vision import ImageRequest
    x = inputs()
    return [ImageRequest(start + i, x[i % BATCH]) for i in range(n)]


# ---------------------------------------------------------------------------
# legs: each runs on every rank and returns what the parent compares
# ---------------------------------------------------------------------------
def leg_data_parallel(ctx):
    import torch
    from repro_torch.vision import compile_forward, graphed_forward
    from repro_torch.vision.mesh import data_mesh, in_mesh
    x = torch.as_tensor(inputs())
    solo = compile_forward(ctx.model)(x)
    out = {}
    for n in (ctx.world, 4, 2):
        mesh = data_mesh(n, device="cpu")
        if not in_mesh(mesh):
            continue
        got = compile_forward(ctx.model, mesh=mesh)(x)
        graphed = graphed_forward(ctx.model, mesh=mesh)(x)
        assert got.shape == solo.shape, (got.shape, solo.shape)
        assert torch.equal(got, solo), (n, float((got - solo).abs().max()))
        assert torch.equal(graphed, solo), n
        out[n] = got.numpy()
    return out


def leg_cout_sharded(ctx):
    import torch
    from repro_torch.kernels.worklist_core import (build_worklist,
                                                   worklist_spmm)
    from repro_torch.vision.mesh import (cout_sharded_spmm, device_mesh,
                                         in_mesh)
    out = {}
    for d in sorted({2, 4, ctx.world}):
        idx, assign, mb, patches, vals, bk, bn, bm = cout_case(d)
        wl = build_worklist(idx, mb, shard_of=assign)
        mesh = device_mesh((d,), ("model",), device="cpu")
        if not in_mesh(mesh):
            continue
        p = torch.as_tensor(patches)
        v = torch.as_tensor(vals)
        full, occ = cout_sharded_spmm(p, v, wl, mesh, bk=bk, bn=bn,
                                      bm_rows=bm, occupancy=True)
        plain = cout_sharded_spmm(p, v, wl, mesh, bk=bk, bn=bn, bm_rows=bm)
        whole, wocc = worklist_spmm(p, v, wl, bk=bk, bn=bn, bm_rows=bm,
                                    sub_m=bm, emit_occupancy=True)
        assert torch.equal(full, whole), float((full - whole).abs().max())
        assert torch.equal(plain, whole)
        assert torch.equal(occ, wocc), (occ, wocc)
        assert occ.shape == (mb, wl.nb), occ.shape
        nometa = build_worklist(idx, mb)
        try:
            cout_sharded_spmm(p, v, nometa, mesh, bk=bk, bn=bn, bm_rows=bm)
        except ValueError as e:
            assert "shard_of" in str(e), e
        else:
            raise AssertionError("a list without shard_of was walked")
        out[d] = (full.numpy(), occ.numpy())
    return out


def leg_engine(ctx):
    from repro_torch.vision import VisionEngine
    from repro_torch.vision.mesh import data_mesh, mesh_schedule_counters
    mesh = data_mesh(ctx.world, device="cpu")
    eng = VisionEngine(ctx.model, num_slots=BATCH, mesh=mesh)
    outs = eng.run(requests(12))
    assert len(outs) == 12
    solo = VisionEngine(ctx.model, num_slots=BATCH).run(requests(12))
    for rid, o in outs.items():
        assert np.array_equal(o, solo[rid]), rid
    eager = VisionEngine(ctx.model, num_slots=BATCH, mesh=mesh,
                         compiled=False).run(requests(12))
    for rid, o in outs.items():
        assert np.array_equal(o, eager[rid]), rid
    try:
        VisionEngine(ctx.model, num_slots=BATCH + 1, mesh=mesh)
    except ValueError:
        pass
    else:
        raise AssertionError("num_slots that does not divide was taken")
    ctx.engine_out = outs
    return {"counters": eng.schedule_counters(),
            "mesh_counters": mesh_schedule_counters(ctx.model, ctx.world),
            "out0": outs[0]}


def leg_elastic(ctx):
    from repro_torch.dist.elastic import FailureSimulator, plan_mesh
    from repro_torch.vision import VisionEngine
    from repro_torch.vision.mesh import data_mesh, in_mesh
    sim = FailureSimulator(fail_at={3: 1, 5: 3})
    alive = sim.surviving(5, ctx.world)
    plan = plan_mesh(alive, model_parallel=1, pod_size=ctx.world)
    assert plan.data == 4 and plan.model == 1, plan
    small = data_mesh(plan.data, device="cpu")
    if not in_mesh(small):
        return {"plan": plan, "member": False}
    eng = VisionEngine(ctx.model, num_slots=BATCH, mesh=small,
                       verify_artifacts=False)
    outs = eng.run(requests(8, start=100))
    assert len(outs) == 8
    for i in range(8):
        assert np.array_equal(outs[100 + i], ctx.engine_out[i]), i
    sc = eng.schedule_counters()
    assert sc["num_devices"] == 4 and len(sc["per_device_steps"]) == 4
    return {"plan": plan, "member": True, "counters": sc}


def leg_server(ctx):
    from repro_torch.serve.vision import (VirtualClock, VisionServer,
                                          WallClock)
    from repro_torch.vision import ImageRequest
    from repro_torch.vision.mesh import data_mesh
    mesh = data_mesh(ctx.world, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [ImageRequest(i, rng.standard_normal(
        (s, s, 3)).astype(np.float32), arrival_s=0.001 * i,
        deadline_s=1.0 + 0.001 * i)
        for i, s in enumerate([20, 24, 30, 18, 32, 24, 12, 28, 24, 31])]
    cost = {24: 0.01, 32: 0.02}
    got = {}
    for name, clock in (("virtual", VirtualClock()), ("wall", WallClock())):
        kw = dict(num_slots=BATCH, buckets=(24, 32), clock=clock,
                  step_cost_s=cost if name == "virtual" else None)
        srv = VisionServer(ctx.model, mesh=mesh, **kw)
        outs = srv.run(reqs)
        kw["clock"] = VirtualClock() if name == "virtual" else WallClock()
        solo = VisionServer(ctx.model, **kw).run(reqs)
        assert sorted(outs) == list(range(len(reqs)))
        for rid, o in outs.items():
            assert np.array_equal(o, solo[rid]), (name, rid)
        got[name] = srv
    sc = got["virtual"].schedule_counters()
    srv = got["virtual"]
    return {"counters": sc, "sla_misses": srv.stats.sla_misses,
            "steps": srv.stats.engine_steps,
            "buckets": {r: srv.records[r].bucket for r in srv.records}}


def leg_collective_matmul(ctx):
    import torch
    from repro_torch.dist.collective_matmul import (allgather_matmul,
                                                    matmul_reducescatter)
    from repro_torch.vision.mesh import device_mesh
    n = ctx.world
    mesh = device_mesh((n,), ("model",), device="cpu")
    g = mesh.get_group("model")
    r = ctx.rank
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    kb, nbk = 64 // n, 32 // n
    xb = torch.as_tensor(x[:, r * kb:(r + 1) * kb])
    ag = allgather_matmul(xb, torch.as_tensor(w.reshape(n, kb, 32)), g)
    rs = matmul_reducescatter(xb, torch.as_tensor(w[r * kb:(r + 1) * kb]), g)
    np.testing.assert_allclose(ag.numpy(), x @ w, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(rs.numpy(), (x @ w)[:, r * nbk:(r + 1) * nbk],
                               rtol=1e-5, atol=1e-4)
    return {"allgather": ag.numpy(), "reducescatter": rs.numpy()}


def leg_hierarchical_psum(ctx):
    import torch
    from repro_torch.dist.compression import hierarchical_psum
    from repro_torch.vision.mesh import device_mesh, in_mesh
    mesh = device_mesh((2, 4), ("pod", "data"), device="cpu")
    if not in_mesh(mesh):
        return {"member": False}
    g = torch.full((1, 16), float(ctx.rank))
    out, stats = hierarchical_psum(g, mesh)
    assert out.dtype == g.dtype
    return {"member": True, "out": out.numpy(), "stats": stats}


def leg_refusals(ctx):
    import torch
    from repro_torch.dist import check_group
    from repro_torch.vision.mesh import data_mesh
    try:
        data_mesh(ctx.world, device="cuda")
    except ValueError as e:
        assert "nccl" in str(e), e
    else:
        raise AssertionError("a CUDA mesh was built on a gloo world")
    fake_cuda = types.SimpleNamespace(is_cuda=True, device="cuda:0")
    try:
        check_group(None, fake_cuda)
    except ValueError as e:
        assert "NCCL" in str(e), e
    else:
        raise AssertionError("a gloo group took a CUDA tensor")
    check_group(None, torch.zeros(1))
    try:
        data_mesh(ctx.world + 1, device="cpu")
    except ValueError:
        pass
    else:
        raise AssertionError("a mesh larger than the world was built")
    return {}


LEGS = [leg_data_parallel, leg_cout_sharded, leg_engine, leg_elastic,
        leg_server, leg_collective_matmul, leg_hierarchical_psum,
        leg_refusals]


def _rank(rank: int, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.vision import build_vision_model
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    ctx = types.SimpleNamespace(rank=rank, world=world, engine_out=None)
    ctx.model = build_vision_model("VGGNet", device="cpu", **MODEL)
    rec = {}
    for leg in LEGS:
        name = leg.__name__[len("leg_"):]
        try:
            rec[name] = ("ok", leg(ctx))
        except Exception:                 # recorded for the parent to show
            rec[name] = ("failed", traceback.format_exc())
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else argv
    out_dir = os.path.abspath(argv[0])
    world = int(argv[1]) if len(argv) > 1 else 8
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(_rank, args=(world, out_dir), nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
