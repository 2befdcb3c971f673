"""A gloo world of CPU ranks that runs the port's sharded LM training legs,
for ``tests/test_torch_dist_lm.py``.

    python tests/torch_dist_lm_world.py OUT_DIR REF_PICKLE [WORLD]

Spawns ``WORLD`` ranks (default 8; one process each, one torch thread, a
``file://`` store in ``OUT_DIR``) that run every leg of :data:`LEGS` in
turn, each under its own timeout (:data:`LEG_TIMEOUT_S`, an alarm in the
rank). Each rank records, per leg, ``"ok"`` or the traceback, and the
arrays the parent compares with the reference, in ``OUT_DIR/rank<r>.pkl``.

Imports the port only (no JAX): ``REF_PICKLE`` holds the reference's
weights and batches as numpy arrays (made by the test process), carried
across with ``convert.params_from_reference``. The mesh is (data=4,
model=2), the model ``load_smoke("qwen3_4b")`` and the shape
``ShapeConfig("t", 32, 4, "train")``, as the reference's own sharded-step
script has them.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import signal
import sys
import tempfile
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

MESH = (4, 2)                       # (data, model)
SHAPE = ("t", 32, 4, "train")
MICRO_BATCH, MICROBATCHES = 8, 2
MOE = "moonshot_v1_16b_a3b"
GROUP_TIMEOUT_S = 120
LEG_TIMEOUT_S = 90


def _np(tree):
    """A tree's leaves as numpy (DTensors gathered first; a collective)."""
    import torch
    from repro_torch.dist.partitioning import gather_tree
    from repro_torch.tree import map_tree
    return map_tree(lambda t: None if t is None else
                    t.detach().numpy() if isinstance(t, torch.Tensor)
                    else t, gather_tree(tree))


def _batch(ref, b: int):
    import torch
    return {k: torch.from_numpy(np.array(v)) for k, v in
            ref[f"batch{b}"].items()}


def _on_mesh(batch, mesh):
    from repro_torch.dist import partitioning as part
    place = part.NamedSharding.of(mesh, part.batch_spec(mesh))
    return {k: part.distribute(v, place) for k, v in batch.items()}


def _sharded_step(ctx, *, fsdp=False, microbatches=1, batch_rows=4,
                  cfg=None, params=None, batch=None):
    """(solo, sharded) of one step on the (4, 2) mesh (loss and gradients,
    accumulated over microbatches as the step does; params and first
    moments after; metrics), every
    tree gathered to numpy; the qwen3 smoke config on the reference's
    weights and batch unless given others."""
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as T
    from repro_torch.train.loop import shardings
    from repro_torch.tree import flatten_tree, map_tree
    cfg = cfg or ctx.cfg
    params = ctx.params if params is None else params
    batch = _batch(ctx.ref, batch_rows) if batch is None else batch
    mesh = make_debug_mesh(MESH[1], MESH[0], device="cpu")
    ocfg = adamw.AdamWConfig(warmup_steps=0)
    step = T.make_train_step(cfg, ocfg, microbatches=microbatches)
    p_sh, o_sh = shardings(cfg, mesh, fsdp)
    sp = part.distribute_tree(params, p_sh)
    sb = _on_mesh(batch, mesh)
    out = {}
    for name, p, b in (("solo", params, batch), ("sharded", sp, sb)):
        rec = {}
        loss, grads = 0.0, None
        for i in range(microbatches):
            mb = {k: T.microbatch(v, i, microbatches) if microbatches > 1
                  else v for k, v in b.items()}
            l_i, _, g = T.loss_and_grads(p, mb, cfg)
            g = adamw.reduce_grads(p, g)
            loss = loss + float(l_i) / microbatches
            grads = map_tree(lambda x: None if x is None
                             else x.float() / microbatches, g) \
                if grads is None else map_tree(
                    lambda a, x: None if x is None
                    else a + x.float() / microbatches, grads, g)
        rec["loss"], rec["grads"] = loss, _np(grads)
        p2, o2, m = step(p, adamw.init(p), b)
        if name == "sharded":
            off = [k for k, v in flatten_tree(p2).items()
                   if tuple(v.placements) != flatten_tree(p_sh)[k]
                   .placements]
            off += [k for k, v in flatten_tree(o2.mu).items()
                    if tuple(v.placements) != flatten_tree(o_sh.mu)[k]
                    .placements]
            assert not off, off
            rec["replicated_mismatch"] = _replicas_differ((p2, o2, m), mesh)
        rec["params"], rec["mu"] = _np(p2), _np(o2.mu)
        rec["metrics"] = {k: float(v) for k, v in m.items()}
        out[name] = rec
    return out


def _replicas_differ(tree, mesh) -> list:
    """Keys of the DTensor leaves whose local tensors differ between ranks
    that replicate them (compared over each mesh dim the leaf is
    replicated on)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.tree import flatten_tree
    bad = []
    for key, t in flatten_tree(tree).items():
        if not isinstance(t, DTensor):
            continue
        local = t.to_local().contiguous()
        for i, pl in enumerate(t.placements):
            if not isinstance(pl, Replicate) or mesh.size(i) == 1:
                continue
            g = mesh.get_group(i)
            parts = [torch.empty_like(local) for _ in range(mesh.size(i))]
            dist.all_gather(parts, local, group=g)
            if not all(torch.equal(p.view(torch.uint8) if p.dtype ==
                                   torch.bfloat16 else p, local.view(
                                       torch.uint8) if local.dtype ==
                                   torch.bfloat16 else local)
                       for p in parts):
                bad.append(f"{key}@{mesh.mesh_dim_names[i]}")
    return bad


# ---------------------------------------------------------------------------
# legs: each runs on every rank and returns what the parent compares
# ---------------------------------------------------------------------------
def leg_tp_dp_step(ctx):
    return _sharded_step(ctx)


def leg_fsdp_step(ctx):
    return _sharded_step(ctx, fsdp=True)


def leg_microbatch_step(ctx):
    return _sharded_step(ctx, microbatches=MICROBATCHES,
                         batch_rows=MICRO_BATCH)


def leg_sp_forward(ctx):
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import act_sharding as AS
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.train_step import sharded
    mesh = make_debug_mesh(MESH[1], MESH[0], device="cpu")
    sp = part.distribute_tree(ctx.params, part.param_shardings(
        mesh, M.abstract_params(ctx.cfg)))
    tokens = _on_mesh(_batch(ctx.ref, 4), mesh)["tokens"]
    seen = []
    plain = AS.constrain_residual

    def spy(x):
        y = plain(x)
        seen.append((tuple(x.placements) if isinstance(x, DTensor) else None,
                     tuple(y.placements) if isinstance(y, DTensor) else None,
                     tuple(y.shape)))
        return y
    with torch.no_grad(), sharded(sp):
        base = M.forward(sp, tokens, ctx.cfg)[0]
        AS.constrain_residual = spy
        try:
            with AS.act_sharding(mesh, AS.sp_spec(mesh)):
                spl = M.forward(sp, tokens, ctx.cfg)[0]
        finally:
            AS.constrain_residual = plain
    want = part.placements(mesh, AS.sp_spec(mesh))
    assert len(seen) == ctx.cfg.n_layers, seen
    assert all(after == want for _, after, _ in seen), (seen, want)
    return {"logits": base.full_tensor().numpy(),
            "sp_logits": spl.full_tensor().numpy(),
            "residual": [(str(b), str(a)) for b, a, _ in seen],
            "want": str(want)}


def leg_constrain_noop(ctx):
    """``constrain_residual`` returns its argument itself outside the
    context, on a decode shape (S = 1), on a rank mismatch and on extents
    that do not divide; a stream it can tile is moved to ``sp_spec``."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import act_sharding as AS
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(MESH[1], MESH[0], device="cpu")
    rep = part.NamedSharding.of(mesh, part.P())

    def dt(*shape):
        return part.distribute(torch.arange(float(np.prod(shape)))
                               .reshape(shape), rep)
    stream = dt(4, 8, 16)
    same = {"outside": AS.constrain_residual(stream) is stream}
    with AS.act_sharding(mesh, AS.sp_spec(mesh)):
        for name, x in (("decode", dt(4, 1, 16)), ("rank", dt(4, 16)),
                        ("seq 3", dt(4, 3, 16)), ("batch 2", dt(2, 8, 16)),
                        ("plain", torch.zeros(4, 8, 16))):
            same[name] = AS.constrain_residual(x) is x
        moved = AS.constrain_residual(stream)
    assert isinstance(moved, DTensor)
    return {"same": same, "moved": str(tuple(moved.placements)),
            "want": str(part.placements(mesh, AS.sp_spec(mesh))),
            "equal": bool(torch.equal(moved.full_tensor(),
                                      stream.full_tensor()))}


def leg_checkpoints(ctx):
    """Save after one step on (4, 2); restore onto (2, 4), (8, 1) and solo;
    a solo checkpoint onto (4, 2): every value bitwise the saved state."""
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as T
    from repro_torch.train.loop import shardings
    cfg = ctx.cfg
    root = os.path.join(ctx.out, "ckpt")
    mesh = make_debug_mesh(MESH[1], MESH[0], device="cpu")
    p_sh, _ = shardings(cfg, mesh, True)
    sp = part.distribute_tree(ctx.params, p_sh)
    step = T.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))
    sp, so, _ = step(sp, adamw.init(sp), _on_mesh(_batch(ctx.ref, 4), mesh))
    ckpt.save(root, 1, sp, so, extra={"mesh": "4,2"})
    want = _np((sp, so))
    abs_p = M.abstract_params(cfg)
    abs_o = adamw.init(abs_p)
    diffs = {}
    for shape in ((4, 2), (2, 4), (8, 1), None):
        if shape is None:
            p, o, _ = ckpt.restore(root, 1, abs_p, abs_o, device="cpu")
        else:
            m = make_debug_mesh(shape[1], shape[0], device="cpu")
            for fsdp in (False, True):
                ps, os_ = shardings(cfg, m, fsdp)
                p, o, _ = ckpt.restore(root, 1, abs_p, abs_o, device="cpu",
                                       shardings=ps, opt_shardings=os_)
                diffs[f"{shape} fsdp={fsdp}"] = _bits_differ(_np((p, o)),
                                                             want)
            continue
        diffs["solo"] = _bits_differ(_np((p, o)), want)
    # a solo checkpoint of the same values (the same tree): the same bytes,
    # and it restores onto a mesh
    solo_p, solo_o = part.gather_tree((sp, so))
    if dist.get_rank() == 0:
        ckpt.save(os.path.join(ctx.out, "ckpt_solo"), 1, solo_p, solo_o,
                  extra={"mesh": "4,2"})
    dist.barrier()
    same = all(open(os.path.join(root, "step_00000001", f), "rb").read() ==
               open(os.path.join(ctx.out, "ckpt_solo", "step_00000001", f),
                    "rb").read()
               for f in ("params.bin", "opt.bin", "manifest.json"))
    ps, os_ = shardings(cfg, mesh, False)
    p, o, _ = ckpt.restore(os.path.join(ctx.out, "ckpt_solo"), 1, abs_p,
                           abs_o, device="cpu", shardings=ps,
                           opt_shardings=os_)
    diffs["solo onto (4, 2)"] = _bits_differ(_np((p, o)), want)
    return {"diffs": diffs, "same_bytes": same}


def _bits_differ(a, b) -> list:
    from repro_torch.tree import flatten_tree
    fa, fb = flatten_tree(a), flatten_tree(b)
    return [k for k in fb if fa[k].dtype != fb[k].dtype
            or fa[k].tobytes() != fb[k].tobytes()]


def leg_train_loop(ctx):
    """``train(mesh=)`` from the seed against solo ``train``; a run of 3
    steps on the mesh resumed from a checkpoint at 2 against 3 steps in
    one run, bitwise."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.loop import TrainLoopConfig, train
    cfg, shape = ctx.cfg, ShapeConfig(*SHAPE)
    mesh = make_debug_mesh(MESH[1], MESH[0], device="cpu")
    ck = os.path.join(ctx.out, "loop_ckpt")
    losses = {}

    def hook(name):
        return lambda s, m: losses.setdefault(name, []).append(m["loss"])
    lc = TrainLoopConfig(steps=2, ckpt_every=1, ckpt_dir=ck, fsdp=True,
                         log_every=10 ** 9)
    train(cfg, shape, lc, mesh=mesh, device="cpu", step_hook=hook("mesh"))
    resumed = train(cfg, shape, dataclasses.replace(lc, steps=3), mesh=mesh,
                    device="cpu", step_hook=hook("resumed"))
    one = train(cfg, shape, TrainLoopConfig(steps=3, fsdp=True,
                                            log_every=10 ** 9),
                mesh=mesh, device="cpu", step_hook=hook("one"))
    solo = train(cfg, shape, TrainLoopConfig(steps=3, log_every=10 ** 9),
                 device="cpu", step_hook=hook("solo"))
    diff = _bits_differ(_np((resumed.params, resumed.opt)),
                        _np((one.params, one.opt)))
    assert resumed.step == 3 and int(resumed.opt.step.full_tensor()) == 3
    dist.barrier()
    return {"losses": losses, "resume_diff": diff,
            "params": _np(one.params), "solo_params": _np(solo.params)}


def leg_launcher(ctx):
    from repro_torch.launch import train as launch
    out = launch.main(["--arch", "qwen3_4b", "--smoke", "--steps", "2",
                       "--seq", "16", "--batch", "4", "--device", "cpu",
                       "--mesh", f"{MESH[0]},{MESH[1]}", "--fsdp"])
    assert out["steps"] == 2, out
    return out


def leg_moe_expert_parallel(ctx):
    """The Moonlight smoke config's sharded step (experts over ``model``)
    against its solo step."""
    from repro_torch.configs.base import ShapeConfig, load_smoke
    from repro_torch.data.pipeline import batch_for
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    cfg = load_smoke(MOE)
    mesh = make_debug_mesh(MESH[1], MESH[0], device="cpu")
    specs = part.param_shardings(mesh, M.abstract_params(cfg))
    bank = specs["blocks"][0]["p0"]["moe"]["w_in"]
    assert str(bank.spec) == "PartitionSpec('model', None, None)", bank
    batch = batch_for(cfg, ShapeConfig(*SHAPE), 0, device="cpu")
    params = M.init_params(cfg, seed=0, device="cpu")
    return {f"fsdp={f}": _sharded_step(ctx, cfg=cfg, params=params,
                                       batch=batch, fsdp=f)
            for f in (False, True)}


LEGS = [leg_tp_dp_step, leg_fsdp_step, leg_microbatch_step, leg_sp_forward,
        leg_constrain_noop, leg_checkpoints, leg_train_loop, leg_launcher,
        leg_moe_expert_parallel]


def _timeout(signum, frame):
    raise TimeoutError(f"the leg ran past {LEG_TIMEOUT_S} s")


def _rank(rank: int, world: int, out_dir: str, ref_path: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import load_smoke
    from repro_torch.convert import params_from_reference
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    ctx = types.SimpleNamespace(rank=rank, world=world, out=out_dir, ref=ref,
                                cfg=load_smoke("qwen3_4b"))
    ctx.params = params_from_reference(ref["params"], device="cpu")
    signal.signal(signal.SIGALRM, _timeout)
    rec = {}
    for leg in LEGS:
        name = leg.__name__[len("leg_"):]
        signal.alarm(LEG_TIMEOUT_S)
        try:
            rec[name] = ("ok", leg(ctx))
        except Exception:                 # recorded for the parent to show
            rec[name] = ("failed", traceback.format_exc())
        signal.alarm(0)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else argv
    out_dir = os.path.abspath(argv[0])
    ref_path = os.path.abspath(argv[1])
    world = int(argv[2]) if len(argv) > 2 else 8
    os.makedirs(out_dir, exist_ok=True)
    tempfile.tempdir = out_dir
    mp.spawn(_rank, args=(world, out_dir, ref_path), nprocs=world,
             join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
