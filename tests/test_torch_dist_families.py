"""Port parity, every LM family's sharded step on a ``DeviceMesh`` (ROADMAP
A8c): the port's sharded train step, prefill and decode steps of RWKV6,
Jamba (attention and Mamba), SeamlessM4T (the encoder and
cross-attention), PaliGemma (the modality prefix), Qwen3 and Moonlight
(MoE) on an 8-rank gloo world, against the port's solo steps and the
reference's sharded steps.

One module-scoped fixture draws the reference's smoke weights and train
batches (``PRNGKey(0)``, ``batch_for(ShapeConfig("t", 32, 4, "train"),
0)``) in this process, pickles them, then runs at once the reference in
subprocesses (8 XLA host devices, a (data=4, model=2) mesh of
``AxisType.Auto`` axes; :data:`REF_GROUPS` split the families over
processes) and the port's world (``tests/torch_dist_families_world.py``)
on those weights. Two layouts: the baseline rules, and ``make_rules``
with SP residuals and the head-sharded decode cache (``--opt``).

The reference runs, under ``jax.jit(in_shardings=...)``: at the baseline
its sharded train step and gradients, ``make_prefill_fn`` and 8 steps of
``make_serve_step`` and ``decode_step`` on a cache placed by
``cache_shardings``; under ``--opt`` the prefill (SP) and the decode
steps (the rules' cache). With one model dim its rules shard every param
as the baseline does, so the port's ``--opt`` train step is held to the
reference's baseline sharded step. Every leg runs on jax 0.9.0; none
falls back to the reference's solo step."""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import ShapeConfig as RShape
from repro.configs.base import load_smoke as r_load
from repro.data.pipeline import batch_for as r_batch_for
from repro.models import model as RM
from repro_torch.convert import STACKS
from repro_torch.tree import flatten_tree

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TOL = 1e-5
LR_EPS = 3e-4 / 1e-8             # AdamWConfig's lr / eps
REF_TIMEOUT_S, WORLD_TIMEOUT_S = 500, 500
ARCHS = ("rwkv6_3b", "jamba_1_5_large_398b", "seamless_m4t_medium",
         "paligemma_3b", "qwen3_4b", "moonshot_v1_16b_a3b")
MODES = ("base", "opt")
# the reference's families by subprocess, about equal compile times
REF_GROUPS = (("jamba_1_5_large_398b",),
              ("rwkv6_3b", "seamless_m4t_medium", "moonshot_v1_16b_a3b"),
              ("paligemma_3b", "qwen3_4b"))
PROMPT, MAX_LEN, STEPS = 8, 16, 8         # as the world's

REF_SCRIPT = r"""
import contextlib, os, pickle, sys, traceback
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
import repro.dist  # noqa: F401
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.base import load_smoke
from repro.dist import partitioning as part
from repro.dist.act_sharding import act_sharding, sp_spec
from repro.models import model as M
from repro.optim import adamw
from repro.serve.engine import make_prefill_fn, make_serve_step
from repro.train import train_step as RT

PROMPT, MAX_LEN, STEPS = 8, 16, 8
np_tree = lambda t: jax.tree.map(np.asarray, t)
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
with open(sys.argv[2], "rb") as f:
    weights = pickle.load(f)
out = {}
for arch in sys.argv[3].split(","):
    cfg = load_smoke(arch)
    params = jax.tree.map(jnp.asarray, weights[arch]["params"])
    batch = jax.tree.map(jnp.asarray, weights[arch]["batch"])
    abs_p = jax.eval_shape(lambda: params)
    B = batch["tokens"].shape[0]
    enc_len = batch["src_embeds"].shape[1] if cfg.encoder_layers else 0
    cache = M.init_cache(cfg, B, MAX_LEN, enc_len=enc_len)
    if cfg.encoder_layers:
        cache = M.prefill_cache(params, cfg, cache,
                                M.encode(params, batch["src_embeds"], cfg))
    last, cache = jax.jit(lambda p, t, c: M.prefill(p, cfg, t, c))(
        params, batch["tokens"][:, :PROMPT], cache)
    rec = {}
    for mode in ("base", "opt"):
        r = {}
        try:
            rules = part.make_rules(mesh, cfg.n_heads, cfg.n_kv_heads) \
                if mode == "opt" else None
            p_sh = part.param_shardings(mesh, abs_p, rules=rules)
            b_sh = {k: NamedSharding(mesh, part.batch_spec(mesh)
                                     if v.ndim == 2 else
                                     P(part.dp_axes(mesh), None, None))
                    for k, v in batch.items()}
            sp = act_sharding(mesh, sp_spec(mesh)) if mode == "opt" \
                else contextlib.nullcontext()
            with mesh, sp:
                ps = jax.tree.map(jax.device_put, params, p_sh)
                bs = {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()}
                if mode == "base":
                    o_sh = adamw.OptState(NamedSharding(mesh, P()), p_sh, p_sh)
                    step = RT.make_train_step(cfg,
                                              adamw.AdamWConfig(warmup_steps=0))
                    p2, _, m = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh))(
                        ps, jax.tree.map(jax.device_put, adamw.init(params),
                                         o_sh), bs)
                    grad_fn = jax.value_and_grad(
                        lambda p, b: RT.loss_fn(p, b, cfg)[0], allow_int=True)
                    loss, g = jax.jit(grad_fn, in_shardings=(p_sh, b_sh))(ps, bs)
                    r["train"] = {
                        "params": np_tree(p2), "loss": float(loss),
                        "metrics": {k: float(v) for k, v in m.items()},
                        "grads": jax.tree.map(
                            lambda x: None if x.dtype == jax.dtypes.float0
                            else np.asarray(x), g)}
                fn = make_prefill_fn(cfg)

                def prefill(p, b):
                    b = dict(b)
                    toks = b.pop("tokens")
                    b.pop("labels")
                    return fn(p, toks, **b)
                r["prefill"] = np.asarray(jax.jit(
                    prefill, in_shardings=(p_sh, b_sh))(ps, bs))
            with mesh:
                c_sh = part.cache_shardings(mesh, jax.eval_shape(lambda: cache),
                                            B, rules=rules)
                t_sh = NamedSharding(mesh, part.batch_spec(mesh))
                cs = jax.tree.map(jax.device_put, cache, c_sh)
                dec = jax.jit(lambda p, c, t, pos: M.decode_step(p, cfg, t, c,
                                                                 pos),
                              in_shardings=(p_sh, c_sh, t_sh, None))
                serve = jax.jit(make_serve_step(cfg),
                                in_shardings=(p_sh, c_sh, t_sh, None))
                tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
                toks, logits = [], []
                for i in range(STEPS):
                    pos = jnp.int32(PROMPT + i)
                    lg, _ = dec(ps, cs, jax.device_put(tok, t_sh), pos)
                    tok, cs = serve(ps, cs, jax.device_put(tok, t_sh), pos)
                    cs = jax.tree.map(jax.device_put, cs, c_sh)
                    toks.append(np.asarray(tok))
                    logits.append(np.asarray(lg))
                r["decode"] = {"tokens": toks, "logits": logits,
                               "cache": np_tree(cs)}
            r["status"] = "ok"
        except Exception:
            r["status"] = traceback.format_exc()[-4000:]
        rec[mode] = r
    out[arch] = rec
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's records by family, the world's run and seconds,
    every rank's records)."""
    out = tmp_path_factory.mktemp("families_world")
    weights = {}
    for arch in ARCHS:
        cfg = r_load(arch)
        weights[arch] = {
            "params": jax.tree.map(np.asarray, RM.init_params(
                jax.random.PRNGKey(0), cfg)),
            "batch": jax.tree.map(np.asarray, r_batch_for(
                cfg, RShape("t", 32, 4, "train"), 0))}
    w_path = out / "weights.pkl"
    with open(w_path, "wb") as f:
        pickle.dump(weights, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(out / f"ref{i}.pkl"),
         str(w_path), ",".join(group)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i, group in enumerate(REF_GROUPS)]
    world = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_families_world.py"),
         str(out), str(w_path), str(WORLD)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = []
    for proc, limit in [(p, REF_TIMEOUT_S) for p in refs] + \
            [(world, WORLD_TIMEOUT_S)]:
        try:
            o, e = proc.communicate(timeout=max(
                1.0, limit - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            o, e = proc.communicate()
        done.append((proc.returncode, o, e))
    seconds = time.perf_counter() - t0
    ref = {}
    for i, (rc, o, e) in enumerate(done[:-1]):
        assert rc == 0 and "REF_OK" in o, e[-3000:]
        with open(out / f"ref{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    recs = {}
    for rank in range(WORLD):
        path = out / f"rank{rank}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                recs[rank] = pickle.load(f)
    return ref, done[-1], seconds, recs


def _leg(runs, arch, mode):
    """Rank 0's record of the leg, after requiring it passed on every
    rank with every leaf in its placements and every replicated leaf equal
    across the ranks that hold it."""
    _, (rc, o, e), _, recs = runs
    for rank in range(WORLD):
        assert rank in recs, f"rank {rank} left no record:\n{e[-3000:]}"
        status, val = recs[rank].get(f"{arch}/{mode}",
                                     ("missing", e[-3000:]))
        assert status == "ok", f"rank {rank} {arch}/{mode}: {val}"
        off = val["off"] + (val["train"]["sharded"]["off"] if rank == 0
                            else val["train_off"])
        assert off == [], (rank, off)
        bad = val["replicated_mismatch"] + (
            val["train"]["sharded"]["replicated_mismatch"] if rank == 0
            else [])
        assert bad == [], (rank, bad)
    return recs[0][f"{arch}/{mode}"][1]


def _ref(runs, arch, mode):
    r = runs[0][arch][mode]
    assert r["status"] == "ok", r["status"]
    return r


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def ref_leaf(tree, key: str):
    """The reference's leaf at the port's ``key`` (a block leaf is period
    ``path[1]`` of the reference's stack; a cache leaf ``p/pos/name`` is
    period ``p`` of the reference's ``pos/name``)."""
    path = tuple(int(s) if s.isdigit() else s for s in key.split("/"))
    if path[0] in STACKS:
        t = tree[path[0]]
        for k in path[2:]:
            t = t[k]
        return None if t is None else np.asarray(t)[path[1]]
    if isinstance(path[0], int):
        t = tree
        for k in path[1:]:
            t = t[k]
        return np.asarray(t)[path[0]]
    for k in path:
        tree = tree[k]
    return None if tree is None else np.asarray(tree)


def test_world_and_reference_ran_to_their_end(runs):
    _, (rc, o, e), seconds, recs = runs
    assert rc == 0, o[-3000:] + e[-3000:]
    assert sorted(recs) == list(range(WORLD))
    print(f"the reference and the world took {seconds:.1f} s together")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_solo_and_reference(runs, arch, mode):
    """Loss and every gradient within 1e-5 of the port's solo step and of
    the reference's sharded step; the metrics within 1e-5; the params
    after one AdamW step within 1e-5 plus AdamW's ``lr * e / eps`` of the
    gradients' error e."""
    rec = _leg(runs, arch, mode)["train"]
    ref = _ref(runs, arch, "base")["train"]
    sh, solo = rec["sharded"], rec["solo"]
    for want in (solo["loss"], ref["loss"]):
        assert _rel(sh["loss"], want) <= TOL
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(sh["metrics"][k], solo["metrics"][k]) <= TOL, k
        assert _rel(sh["metrics"][k], ref["metrics"][k]) <= TOL, k
    grads = flatten_tree(sh["grads"])
    solo_g = flatten_tree(solo["grads"])
    for key, g in grads.items():
        if g is None:                   # an integer leaf (expert_perm)
            continue
        assert _rel(g, solo_g[key]) <= TOL, key
        assert _rel(g, ref_leaf(ref["grads"], key)) <= TOL, key
    for key, p in flatten_tree(sh["params"]).items():
        for want, g_want in ((flatten_tree(solo["params"])[key],
                              solo_g[key]),
                             (ref_leaf(ref["params"], key),
                              ref_leaf(ref["grads"], key))):
            if grads[key] is None:
                assert np.array_equal(p, want), key
                continue
            g_err = np.abs(grads[key] - g_want).max()
            bound = TOL * np.abs(want).max() + LR_EPS * g_err * 1.01
            assert np.abs(p - want).max() <= bound, key


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_solo_and_reference(runs, arch, mode):
    """``make_prefill_fn``'s last-position logits (with the prefix or the
    encoder input) within 1e-5 of solo and of the reference's sharded
    prefill; the cache-writing prefill's within 1e-5 of solo."""
    rec = _leg(runs, arch, mode)
    ref = _ref(runs, arch, mode)
    assert _rel(rec["prefill"]["sharded"], rec["prefill"]["solo"]) <= TOL
    assert _rel(rec["prefill"]["sharded"], ref["prefill"]) <= TOL
    cp = rec["cache_prefill"]
    assert _rel(cp["sharded"], cp["solo"]) <= TOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_solo_and_reference(runs, arch, mode):
    """8 greedy ``make_serve_step`` steps on a ``cache_shardings``-placed
    cache: the tokens equal to solo's and the reference's sharded serve
    step's, each step's logits within 1e-5 of both, every cache leaf
    within 1e-5 of both after the last step (and in its placements on
    every rank, :func:`_leg`)."""
    rec = _leg(runs, arch, mode)["decode"]
    ref = _ref(runs, arch, mode)["decode"]
    for i in range(STEPS):
        assert np.array_equal(rec["tokens"]["sharded"][i],
                              rec["tokens"]["solo"][i]), i
        assert np.array_equal(rec["tokens"]["sharded"][i],
                              np.asarray(ref["tokens"][i])), i
        assert _rel(rec["logits"]["sharded"][i], rec["logits"]["solo"][i]) \
            <= TOL, i
        assert _rel(rec["logits"]["sharded"][i], ref["logits"][i]) <= TOL, i
    solo_c = flatten_tree(rec["solo_cache"])
    for key, c in flatten_tree(rec["cache"]).items():
        assert c.shape == solo_c[key].shape, key
        if np.abs(solo_c[key]).max() == 0:
            assert np.abs(c).max() == 0, key
            continue
        assert _rel(c, solo_c[key]) <= TOL, key
        assert _rel(c, ref_leaf(ref["cache"], key)) <= TOL, key
