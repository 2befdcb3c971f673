"""Port parity, sharded LM training on a ``DeviceMesh`` (ROADMAP A8b): the
port's DTensor step on gloo worlds of CPU ranks against its solo step and
the reference's sharded step.

One module-scoped fixture runs the reference in a subprocess (8 XLA host
devices, a (data=4, model=2) mesh of ``AxisType.Auto`` axes: its sharded
step with and without FSDP and microbatched, its gradients, the SP forward,
its ``param_shardings`` and ``cache_shardings`` specs) and then an 8-rank
world (``tests/torch_dist_lm_world.py``) on the reference's weights; each
test reads one leg's record from every rank: the TP+DP, FSDP and
microbatched steps (loss and every gradient within 1e-5 of solo and of the
reference, the params within AdamW's ``lr * e / eps`` bound, every
replicated leaf bitwise equal across the ranks that hold it), the SP
forward, ``constrain_residual``'s no-op cases, checkpoints restarted across
(4, 2), (2, 4), (8, 1) and solo, ``train(mesh=)`` resumed, the launcher
with ``--mesh 4,2 --fsdp``, and the Moonlight smoke config's expert-parallel
step. Without a world: ``placements`` and its refusals, ``param_shardings``
on stub meshes equal to the reference's specs, the production mesh shapes,
and the balance helpers."""
import dataclasses
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.dist  # noqa: F401  (installs the jax.shard_map shim)
from repro.configs import base as r_base
from repro.core import balance as r_bal
from repro.dist import partitioning as r_part
from repro.models import model as RM
from repro_torch.configs import base as t_base
from repro_torch.convert import STACKS
from repro_torch.core import balance as t_bal
from repro_torch.dist import act_sharding as AS
from repro_torch.dist import partitioning as part
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import model as M
from repro_torch.tree import flatten_tree

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TOL = 1e-5
LR_EPS = 3e-4 / 1e-8             # AdamWConfig's lr / eps
REF_TIMEOUT_S, WORLD_TIMEOUT_S = 300, 400

REF_SCRIPT = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
import repro.dist  # noqa: F401
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.base import load_smoke, ShapeConfig
from repro.data.pipeline import batch_for
from repro.dist import partitioning as part
from repro.dist.act_sharding import act_sharding, sp_spec
from repro.models import model as M
from repro.optim import adamw
from repro.train import train_step as RT

out = {}
np_tree = lambda t: jax.tree.map(np.asarray, t)
spec_tree = lambda sh: jax.tree.map(lambda s: tuple(s.spec), sh,
    is_leaf=lambda x: isinstance(x, NamedSharding))
cfg = load_smoke("qwen3_4b")
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
params = M.init_params(jax.random.PRNGKey(0), cfg)
out["params"] = np_tree(params)
ocfg = adamw.AdamWConfig(warmup_steps=0)
abs_p = jax.eval_shape(lambda: params)
grad_fn = jax.value_and_grad(lambda p, b: RT.loss_fn(p, b, cfg)[0])
for name, fsdp, B, mb in (("tp_dp", False, 4, 1), ("fsdp", True, 4, 1),
                          ("micro", False, 8, 2)):
    batch = batch_for(cfg, ShapeConfig("t", 32, B, "train"), 0)
    out[f"batch{B}"] = np_tree(batch)
    p_sh = part.param_shardings(mesh, abs_p, fsdp=fsdp)
    o_sh = adamw.OptState(NamedSharding(mesh, P()), p_sh, p_sh)
    b_sh = {k: NamedSharding(mesh, part.batch_spec(mesh)) for k in batch}
    with mesh:
        ps = jax.tree.map(jax.device_put, params, p_sh)
        os_ = jax.tree.map(jax.device_put, adamw.init(params), o_sh)
        bs = {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()}
        step = RT.make_train_step(cfg, ocfg, microbatches=mb)
        p2, o2, m = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh))(
            ps, os_, bs)
        loss, grads = 0.0, None
        for i in range(mb):
            part_b = {k: v.reshape(mb, B // mb, *v.shape[1:])[i]
                      for k, v in batch.items()}
            l, g = jax.jit(grad_fn)(ps, part_b)
            loss += float(l) / mb
            g = jax.tree.map(lambda x: np.asarray(x, np.float32) / mb, g)
            grads = g if grads is None else jax.tree.map(np.add, grads, g)
    out[name] = {"params": np_tree(p2), "mu": np_tree(o2.mu),
                 "metrics": {k: float(v) for k, v in m.items()},
                 "specs": spec_tree(p_sh), "loss": loss, "grads": grads}
batch = batch_for(cfg, ShapeConfig("t", 32, 4, "train"), 0)
p_sh = part.param_shardings(mesh, abs_p)
with mesh:
    ps = jax.tree.map(jax.device_put, params, p_sh)
    with act_sharding(mesh, sp_spec(mesh)):
        out["sp_logits"] = np.asarray(jax.jit(
            lambda p, t: M.forward(p, t, cfg)[0])(ps, batch["tokens"]))
abs_cache = jax.eval_shape(lambda: M.init_cache(cfg, 4, 64))
out["cache_specs"] = {b: spec_tree(part.cache_shardings(mesh, abs_cache, b))
                      for b in (4, 2)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the reference's record, the world's run, every rank's records)."""
    out = tmp_path_factory.mktemp("lm_world")
    ref_path = out / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(ref_path)],
                       env=env, capture_output=True, text=True,
                       timeout=REF_TIMEOUT_S)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-3000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    run = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "torch_dist_lm_world.py"),
                          str(out), str(ref_path), str(WORLD)], env=env,
                         capture_output=True, text=True,
                         timeout=WORLD_TIMEOUT_S)
    recs = {}
    for rank in range(WORLD):
        path = out / f"rank{rank}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                recs[rank] = pickle.load(f)
    return ref, run, recs


def _leg(world, name):
    """The leg's results by rank, after requiring it passed on each."""
    _, run, recs = world
    got = {}
    for rank in range(WORLD):
        assert rank in recs, \
            f"rank {rank} left no record:\n{run.stderr[-3000:]}"
        status, val = recs[rank].get(name, ("missing", run.stderr[-3000:]))
        assert status == "ok", f"rank {rank} leg {name}: {val}"
        got[rank] = val
    return got


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def ref_leaf(tree, key: str):
    """The reference's leaf at the port's ``key``: a block leaf is period
    ``path[1]`` of the reference's stack."""
    path = tuple(int(s) if s.isdigit() else s for s in key.split("/"))
    if path[0] in STACKS:
        t = tree[path[0]]
        for k in path[2:]:
            t = t[k]
        return np.asarray(t)[path[1]]
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_world_ran_to_its_end(world):
    _, run, recs = world
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert sorted(recs) == list(range(WORLD))


STEPS = {"tp_dp": "tp_dp_step", "fsdp": "fsdp_step",
         "micro": "microbatch_step"}


@pytest.mark.parametrize("kind", list(STEPS))
def test_sharded_step_matches_solo_and_reference(world, kind):
    """Loss and every gradient within 1e-5 of the port's solo step and of
    the reference's sharded step; the metrics and first moments within
    1e-5; the params within 1e-5 plus AdamW's ``lr * e / eps`` of the
    gradients' error e (test_torch_train.py's bound); every rank holds the
    same gathered values."""
    ref = world[0][kind]
    got = _leg(world, STEPS[kind])
    rec, solo = got[0]["sharded"], got[0]["solo"]
    for rank in range(1, WORLD):
        r = got[rank]["sharded"]
        assert r["metrics"] == rec["metrics"], rank
        for key, v in flatten_tree(r["params"]).items():
            assert np.array_equal(v, flatten_tree(rec["params"])[key]), \
                (rank, key)
    for want, where in ((solo["loss"], "solo"), (ref["loss"], "reference")):
        assert _rel(rec["loss"], want) <= TOL, where
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(rec["metrics"][k], ref["metrics"][k]) <= TOL, k
        assert _rel(rec["metrics"][k], solo["metrics"][k]) <= TOL, k
    grads = flatten_tree(rec["grads"])
    for key, g in grads.items():
        assert _rel(g, flatten_tree(solo["grads"])[key]) <= TOL, key
        assert _rel(g, ref_leaf(ref["grads"], key)) <= TOL, key
    for key, p in flatten_tree(rec["params"]).items():
        for want, g_want in ((flatten_tree(solo["params"])[key],
                              flatten_tree(solo["grads"])[key]),
                             (ref_leaf(ref["params"], key),
                              ref_leaf(ref["grads"], key))):
            g_err = np.abs(grads[key] - g_want).max()
            bound = TOL * np.abs(want).max() + LR_EPS * g_err * 1.01
            assert np.abs(p - want).max() <= bound, key
        assert _rel(flatten_tree(rec["mu"])[key],
                    ref_leaf(ref["mu"], key)) <= TOL, key


@pytest.mark.parametrize("kind", list(STEPS))
def test_replicated_leaves_bitwise_across_ranks(world, kind):
    """After the step every replicated leaf (params, moments, metrics) is
    bitwise equal on every rank of each mesh dim that replicates it."""
    got = _leg(world, STEPS[kind])
    for rank, rec in got.items():
        assert rec["sharded"]["replicated_mismatch"] == [], rank


def test_param_specs_on_the_world_equal_reference(world):
    """The (4, 2) mesh's ``param_shardings`` specs (plain and FSDP) equal
    the reference's ``param_shardings`` on its (4, 2) mesh, less the
    stacked periods entry."""
    ref = world[0]
    stub = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 4, "model": 2})
    abs_p = M.abstract_params(t_base.load_smoke("qwen3_4b"))
    for kind, fsdp in (("tp_dp", False), ("fsdp", True)):
        got = flatten_tree(part.param_shardings(stub, abs_p, fsdp=fsdp))
        for key, sh in got.items():
            want = ref_spec(ref[kind]["specs"], key)
            assert _trim(sh.spec) == want, (kind, key)


def ref_spec(specs, key):
    """The reference's spec of the port's leaf ``key``, its periods entry
    dropped, trailing replicated entries trimmed (a spec may be shorter
    than the tensor's rank)."""
    path = tuple(int(s) if s.isdigit() else s for s in key.split("/"))
    t = specs[path[0]]
    for k in (path[2:] if path[0] in STACKS else path[1:]):
        t = t[k]
    t = tuple(t)
    if path[0] in STACKS:
        assert t[0] is None, key
        t = t[1:]
    return _trim(t)


def _trim(spec) -> tuple:
    """A spec without its trailing replicated entries."""
    t = tuple(spec)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def test_sp_forward_matches_plain_and_reference(world):
    """The forward under ``act_sharding(mesh, sp_spec(mesh))`` equals the
    forward without it within 1e-5 and the reference's SP forward; after
    every block the residual is in ``sp_spec``'s placements."""
    got = _leg(world, "sp_forward")
    r = got[0]
    assert _rel(r["sp_logits"], r["logits"]) <= TOL
    assert _rel(r["sp_logits"], world[0]["sp_logits"]) <= TOL
    assert r["want"] == "(Shard(dim=0), Shard(dim=1))"
    assert [a for _, a in r["residual"]] == [r["want"]] * 2
    for rank in range(1, WORLD):
        assert np.array_equal(got[rank]["sp_logits"], r["sp_logits"])


def test_constrain_residual_no_op_cases(world):
    for rank, r in _leg(world, "constrain_noop").items():
        assert r["same"] == {"outside": True, "decode": True, "rank": True,
                             "seq 3": True, "batch 2": True, "plain": True}
        assert r["moved"] == r["want"] and r["equal"], rank


def test_checkpoint_restarts_across_meshes_bitwise(world):
    """A checkpoint saved on (4, 2) restores bitwise onto (4, 2), (2, 4),
    (8, 1) (with and without FSDP) and solo; the solo save of the same
    values has the same bytes, and restores onto (4, 2) bitwise."""
    for rank, r in _leg(world, "checkpoints").items():
        assert sorted(r["diffs"]) == sorted(
            [f"{s} fsdp={f}" for s in ((4, 2), (2, 4), (8, 1))
             for f in (False, True)] + ["solo", "solo onto (4, 2)"])
        assert all(v == [] for v in r["diffs"].values()), (rank, r["diffs"])
        assert r["same_bytes"], rank


def test_train_on_the_mesh_resumes_and_matches_solo(world):
    """``train(mesh=, fsdp)``: 2 steps with a checkpoint each, then a fresh
    ``train`` to 3 resumed at 2 equals 3 steps in one run bitwise; the
    losses and params track solo ``train`` within the step tolerance."""
    got = _leg(world, "train_loop")
    r = got[0]
    assert r["resume_diff"] == []
    losses = r["losses"]
    assert len(losses["mesh"]) == 2 and len(losses["resumed"]) == 1
    assert losses["one"][:2] == losses["mesh"]
    assert losses["one"][2] == losses["resumed"][0]
    for a, b in zip(losses["one"], losses["solo"]):
        assert abs(a - b) <= TOL * abs(b)
    for key, p in flatten_tree(r["params"]).items():
        want = flatten_tree(r["solo_params"])[key]
        assert np.abs(p - want).max() <= 1e-3 * max(np.abs(want).max(),
                                                    1.0), key
    for rank in range(1, WORLD):
        assert got[rank]["losses"] == losses


def test_launcher_trains_on_the_mesh(world):
    for rank, out in _leg(world, "launcher").items():
        assert out["steps"] == 2 and np.isfinite(out["step_ms"]), rank


@pytest.mark.parametrize("fsdp", [False, True])
def test_moe_expert_parallel_step_matches_solo(world, fsdp):
    """Moonlight smoke (8 experts, 2 a rank over ``model``): the sharded
    step's loss, metrics and gradients within 1e-5 of solo, the params
    within the AdamW bound."""
    got = _leg(world, "moe_expert_parallel")
    rec = got[0][f"fsdp={fsdp}"]
    sh, solo = rec["sharded"], rec["solo"]
    assert _rel(sh["loss"], solo["loss"]) <= TOL
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        assert abs(sh["metrics"][k] - solo["metrics"][k]) <= \
            TOL * max(abs(solo["metrics"][k]), 1e-3), k
    grads, sg = flatten_tree(sh["grads"]), flatten_tree(solo["grads"])
    for key, g in grads.items():
        if g is not None:
            assert _rel(g, sg[key]) <= TOL, key
    for key, p in flatten_tree(sh["params"]).items():
        want = flatten_tree(solo["params"])[key]
        if not np.issubdtype(p.dtype, np.floating):
            assert np.array_equal(p, want), key
            continue
        bound = TOL * np.abs(want).max() + LR_EPS * np.abs(
            grads[key] - sg[key]).max() * 1.01
        assert np.abs(p - want).max() <= bound, key
    assert sh["replicated_mismatch"] == []


# ---------------------------------------------------------------------------
# without a world
# ---------------------------------------------------------------------------
def _stub(shape, names):
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, shape)))


def test_placements_shard_and_replicate():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _stub((2, 4, 2), ("data", "model1", "model2"))
    assert part.placements(mesh, part.P()) == (Replicate(),) * 3
    assert part.placements(mesh, part.P(None, ("model1", "model2")),
                           (6, 16)) == (Replicate(), Shard(1), Shard(1))
    assert part.placements(mesh, part.P("data", None, "model2")) == \
        (Shard(0), Replicate(), Shard(2))


@pytest.mark.parametrize("spec,shape,why", [
    ((("model2", "model1"),), (16,), "order"),        # out of mesh order
    ((("model1", "data"),), (16,), "order"),
    (("data", "data"), (4, 4), "twice"),
    (("model1",), (6,), "divide"),                    # 6 over 4 ranks
    ((("data", "model2"),), (6,), "divide"),
    (("pod",), (4,), "no dim"),
])
def test_placements_refuses(spec, shape, why):
    mesh = _stub((2, 4, 2), ("data", "model1", "model2"))
    with pytest.raises(ValueError, match=why):
        part.placements(mesh, part.P(*spec), shape)


@pytest.mark.parametrize("arch", t_base.ARCHS)
@pytest.mark.parametrize("mesh_shape", [((4, 2), ("data", "model")),
                                        ((16, 8, 2),
                                         ("data", "model1", "model2"))])
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_shardings_equal_reference_specs(arch, mesh_shape, fsdp):
    """``param_shardings`` on a stub mesh: the reference's ``param_specs``
    with ``Rules(sizes=...)`` (its ``param_shardings``' specs), less the
    periods entry; each placement as ``placements`` gives it."""
    shape, names = mesh_shape
    stub = _stub(shape, names)
    sizes = dict(zip(names, shape))
    tp = tuple(a for a in names if a.startswith("model"))
    rules = r_part.Rules(tp=tp, q_axes=tp, kv_axes=tp, sizes=sizes)
    r_abs = RM.abstract_params(r_base.load_smoke(arch))
    want = r_part.param_specs(r_abs, fsdp=sizes["data"] if fsdp else 0,
                              rules=rules)
    want = jax.tree.map(tuple, want,
                        is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))
    abs_p = M.abstract_params(t_base.load_smoke(arch))
    got = flatten_tree(part.param_shardings(stub, abs_p, fsdp=fsdp))
    assert list(got) == list(flatten_tree(abs_p))
    for key, sh in got.items():
        assert _trim(sh.spec) == ref_spec(want, key), key
        leaf = flatten_tree(abs_p)[key]
        assert sh.placements == part.placements(stub, sh.spec, leaf.shape)


def test_cache_shardings_equal_reference(world):
    """``cache_shardings`` of the port's per-period cache on a stub (4, 2)
    mesh: the reference's specs less the periods entry, with its fallback
    (a batch of 2 does not divide over 4 data ranks: replicated)."""
    stub = _stub((4, 2), ("data", "model"))
    cfg = t_base.load_smoke("qwen3_4b")
    cache = M.init_cache(cfg, 4, 64, device="meta")
    for b in (4, 2):
        got = flatten_tree(part.cache_shardings(stub, cache, b))
        want = world[0]["cache_specs"][b]
        for key, sh in got.items():
            _, pos, name = key.split("/")
            w = tuple(want[pos][name])[1:]
            spec = tuple(sh.spec)
            assert spec + (None,) * (len(w) - len(spec)) == w, (b, key)


def test_act_sharding_outside_a_world():
    """Plain tensors pass ``constrain_residual`` untouched, in a context
    or not; ``sp_spec`` names the data and model dims."""
    mesh = _stub((2, 4), ("data", "model"))
    x = torch.zeros(2, 8, 4)
    assert AS.constrain_residual(x) is x
    with AS.act_sharding(mesh, AS.sp_spec(mesh)):
        assert AS.constrain_residual(x) is x
    assert AS._STACK == []
    assert tuple(AS.sp_spec(mesh)) == ("data", "model", None)
    multi = _stub((2, 16, 8, 2), ("pod", "data", "model1", "model2"))
    assert tuple(AS.sp_spec(multi)) == (("pod", "data"),
                                        ("model1", "model2"), None)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("split_model", [False, True])
def test_production_mesh_shapes(multi_pod, split_model):
    """The reference's production meshes: (16, 16), (2, 16, 16), (16, 8,
    2), (2, 16, 8, 2) and their dim names; building one needs a world of
    256 (512) ranks."""
    shape, names = t_mesh.production_shape(multi_pod=multi_pod,
                                           split_model=split_model)
    want = {(False, False): ((16, 16), ("data", "model")),
            (True, False): ((2, 16, 16), ("pod", "data", "model")),
            (False, True): ((16, 8, 2), ("data", "model1", "model2")),
            (True, True): ((2, 16, 8, 2),
                           ("pod", "data", "model1", "model2"))}
    assert (shape, names) == want[(multi_pod, split_model)]
    if not torch.distributed.is_initialized() and \
            "WORLD_SIZE" not in os.environ:
        with pytest.raises(RuntimeError, match="world of processes"):
            t_mesh.make_production_mesh(multi_pod=multi_pod,
                                        split_model=split_model,
                                        device="cpu")


@pytest.mark.parametrize("lanes,subchunks", [(2, 4), (4, 8), (4, 16),
                                             (8, 16)])
def test_rotate_assignment_equal_reference(rng, lanes, subchunks):
    work = rng.random((6, subchunks))
    assert t_bal.rotate_assignment(work, lanes, 6) == \
        r_bal.rotate_assignment(work, lanes, 6)


@pytest.mark.parametrize("experts,devices", [(8, 2), (16, 4), (64, 8),
                                             (7, 3)])
@pytest.mark.parametrize("step", [0, 1, 5])
def test_expert_placement_equal_reference(rng, experts, devices, step):
    load = rng.random(experts)
    got = t_bal.expert_placement(load, devices, step)
    np.testing.assert_array_equal(got, r_bal.expert_placement(load, devices,
                                                              step))
    counts = np.bincount(got, minlength=devices)
    assert counts.max() - counts.min() <= 1


def test_train_loop_refuses_fsdp_without_a_mesh():
    from repro_torch.train.loop import init_state
    cfg = dataclasses.replace(t_base.load_smoke("qwen3_4b"), n_layers=1)
    with pytest.raises(ValueError, match="mesh"):
        init_state(cfg, fsdp=True, device="cpu")
