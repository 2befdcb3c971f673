"""Port parity, training: the loss, its gradients, microbatch accumulation,
remat, AdamW and the data pipeline of ``repro_torch`` against the JAX
reference on the same numpy batch (the reference's ``batch_for``) and the
same weights (``convert.params_from_reference``), on the 2-layer smoke
configs of Qwen3-4B and the Moonlight MoE, fp32 on the CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.data import pipeline as r_data
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.train import train_step as RT
from repro_torch.configs import base as t_base
from repro_torch.convert import STACKS, params_from_reference
from repro_torch.data import pipeline as t_data
from repro_torch.launch import train as t_launch
from repro_torch.models import model as M
from repro_torch.optim import adamw as A
from repro_torch.train import train_step as T
from repro_torch.tree import flatten_tree, map_tree, map_tree_with_path

CPU = torch.device("cpu")
TOL = 1e-5
SHAPE = ("t", 32, 4, "train")
MOE = "moonshot_v1_16b_a3b"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def ref_leaf(tree, path):
    """The reference's leaf at the port's ``path``: a block leaf is the
    period ``path[1]`` of the reference's stack."""
    if path[0] in STACKS:
        t = tree[path[0]]
        for k in path[2:]:
            t = t[k]
        return np.asarray(t)[path[1]]
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def worst(port_tree, ref_tree):
    """The largest per-leaf rel err of a port tree against the
    reference's (``None`` leaves skipped)."""
    errs = flatten_tree(map_tree_with_path(
        lambda p, x: 0.0 if x is None else _rel(x.numpy(),
                                                ref_leaf(ref_tree, p)),
        port_tree))
    return max(errs.values())


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(ref cfg, port cfg, ref params, port params, numpy batch, port
    batch)."""
    rc, tc = r_base.load_smoke(arch), t_base.load_smoke(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   rc)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    nb = {k: np.asarray(v) for k, v in
          r_data.batch_for(rc, r_base.ShapeConfig(*SHAPE), 0).items()}
    tb = {k: torch.from_numpy(v.copy()) for k, v in nb.items()}
    return rc, tc, rp, tp, nb, tb


def test_cross_entropy_matches_reference(rng):
    logits = rng.normal(size=(2, 5, 37)).astype(np.float32) * 4
    labels = rng.integers(0, 37, (2, 5)).astype(np.int32)
    rce, rz = RT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tce, tz = T.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    assert _rel(tce, rce) <= TOL and _rel(tz, rz) <= TOL
    gold = torch.full((2, 3, 8), -10.0)
    gold[:, :, 1] = 10.0
    assert float(T.cross_entropy(gold, torch.ones((2, 3)))[0]) < 1e-3


@functools.lru_cache(maxsize=None)
def ref_grads(arch, perm=None):
    """((loss, aux), grads) of the reference's ``loss_fn`` on ``setup``'s
    params (``perm``: a tuple for ``expert_perm``)."""
    rc, _, rp, _, nb, _ = setup(arch)
    if perm is not None:
        rp = dict(rp, expert_perm=jnp.asarray(perm, jnp.int32))
    return jax.jit(jax.value_and_grad(lambda p, b: RT.loss_fn(p, b, rc),
                                      has_aux=True, allow_int=True))(rp, nb)


@pytest.mark.parametrize("arch", ["qwen3_4b", MOE])
def test_loss_and_grads_match_reference(arch):
    rc, tc, rp, tp, nb, tb = setup(arch)
    (rl, raux), rg = ref_grads(arch)
    tl, taux, tg = T.loss_and_grads(tp, tb, tc)
    assert _rel(tl, rl) <= TOL and _rel(taux["ce"], raux["ce"]) <= TOL
    assert abs(float(taux["moe_aux"]) - float(raux["moe_aux"])) \
        <= TOL * max(abs(float(raux["moe_aux"])), 1.0)
    assert worst(tg, rg) <= TOL
    if "expert_perm" in tp:
        assert tg["expert_perm"] is None       # an integer leaf


@pytest.mark.parametrize("clip", [1.0, None])
def test_train_step_matches_reference(clip):
    """One step on Qwen3 smoke: the loss, the metrics, the params after
    AdamW and both moments within 1e-5 of the reference's."""
    rc, tc, rp, tp, nb, tb = setup("qwen3_4b")
    kw = dict(clip_norm=clip, warmup_steps=0)
    rp2, ro2, rm = jax.jit(RT.make_train_step(rc, RA.AdamWConfig(**kw)))(
        rp, RA.init(rp), nb)
    tp2, to2, tm = T.make_train_step(tc, A.AdamWConfig(**kw))(
        tp, A.init(tp), tb)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(tm[k], rm[k]) <= TOL, k
    assert worst(tp2, rp2) <= TOL
    assert worst(to2.mu, ro2.mu) <= TOL and worst(to2.nu, ro2.nu) <= TOL
    assert int(to2.step) == int(ro2.step) == 1
    assert to2.step.dtype == torch.int32
    # the step left its inputs alone
    assert torch.equal(tp["embed"], torch.from_numpy(
        np.array(rp["embed"])))


def test_moe_train_step_matches_reference():
    """The MoE step: loss, metrics and the moments within 1e-5; the params
    within what AdamW makes of the gradients' rounding. Where a gradient is
    near ``eps`` the update ``g / (|g| + eps)`` turns an absolute gradient
    error e into up to ``lr * e / eps`` of param, so the params are held to
    1e-5 plus that bound, e taken from the two packages' gradients."""
    rc, tc, rp, tp, nb, tb = setup(MOE)
    perm = np.random.default_rng(0).permutation(
        rc.moe.num_experts).astype(np.int32)
    rp = dict(rp, expert_perm=jnp.asarray(perm))
    tp = dict(tp, expert_perm=torch.from_numpy(perm))
    cfg = A.AdamWConfig()
    rp2, ro2, rm = jax.jit(RT.make_train_step(rc, RA.AdamWConfig()))(
        rp, RA.init(rp), nb)
    tp2, to2, tm = T.make_train_step(tc, cfg)(tp, A.init(tp), tb)
    for k in ("loss", "ce", "moe_aux", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(rm[k])) \
            <= TOL * max(abs(float(rm[k])), 1e-3), k
    assert worst(to2.mu, ro2.mu) <= TOL and worst(to2.nu, ro2.nu) <= TOL
    np.testing.assert_array_equal(tp2["expert_perm"].numpy(), perm)
    assert tp2["expert_perm"].dtype == torch.int32
    _, rg = ref_grads(MOE, tuple(perm.tolist()))
    _, _, tg = T.loss_and_grads(tp, tb, tc)
    lr = float(tm["lr"])
    for key, p2 in flatten_tree(tp2).items():
        if not p2.is_floating_point():
            continue
        path = tuple(int(s) if s.isdigit() else s for s in key.split("/"))
        g_err = np.abs(flatten_tree(tg)[key].numpy()
                       - ref_leaf(rg, path)).max()
        ref = ref_leaf(rp2, path)
        bound = TOL * np.abs(ref).max() + lr * g_err / cfg.eps * 1.01
        assert np.abs(p2.numpy() - ref).max() <= bound, key


@pytest.mark.parametrize("arch", ["qwen3_4b", MOE])
def test_microbatches_match_reference(arch):
    """``microbatches=2``: fp32 accumulation of each half's gradients; the
    metrics mirror the reference's ("ce" the total loss, "moe_aux" 0)."""
    rc, tc, rp, tp, nb, tb = setup(arch)
    rp2, ro2, rm = jax.jit(RT.make_train_step(
        rc, RA.AdamWConfig(), microbatches=2))(rp, RA.init(rp), nb)
    tp2, to2, tm = T.make_train_step(tc, A.AdamWConfig(), microbatches=2)(
        tp, A.init(tp), tb)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert _rel(tm[k], rm[k]) <= TOL, k
    assert float(tm["moe_aux"]) == float(rm["moe_aux"]) == 0.0
    assert worst(to2.mu, ro2.mu) <= TOL
    with pytest.raises(ValueError, match="microbatches"):
        T.make_train_step(tc, A.AdamWConfig(), microbatches=3)(
            tp, A.init(tp), tb)


@pytest.mark.parametrize("arch", ["qwen3_4b", MOE])
def test_remat_is_bitwise_equal_to_no_remat(arch):
    """Checkpointing recomputes the same forward: loss and every gradient
    bitwise equal with and without it, per period and per group of 2."""
    _, tc, _, tp, _, tb = setup(arch)
    l0, _, g0 = T.loss_and_grads(tp, tb, tc, remat=False)
    for group in (1, 2):
        l1, _, g1 = T.loss_and_grads(tp, tb, tc, remat=True,
                                     remat_group=group)
        assert torch.equal(l0, l1)
        for a, b in zip(flatten_tree(g0).values(),
                        flatten_tree(g1).values()):
            assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="remat_group"):
        T.loss_and_grads(tp, tb, tc, remat_group=3)


@pytest.mark.parametrize("arch", ["qwen3_4b", MOE])
def test_donated_step_is_bitwise_the_functional_one(arch):
    """``donate=True`` (the loop's step) writes the same bits into the
    params and moments it was given, and leaves integer leaves alone."""
    _, tc, _, tp, _, tb = setup(arch)
    cfg = A.AdamWConfig(warmup_steps=0)
    want = T.make_train_step(tc, cfg)(tp, A.init(tp), tb)
    params = map_tree(torch.clone, tp)
    opt = A.init(params)
    ptrs = [t.data_ptr() for t in flatten_tree((params, opt.mu,
                                                opt.nu)).values()]
    got = T.make_train_step(tc, cfg, donate=True)(params, opt, tb)
    assert [t.data_ptr() for t in flatten_tree(
        (got[0], got[1].mu, got[1].nu)).values()] == ptrs
    for a, b in zip(flatten_tree(want).values(),
                    flatten_tree(got).values()):
        assert torch.equal(a, b)


def test_schedule_matches_reference():
    c = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        r = float(RA.schedule(RA.AdamWConfig(**c), jnp.int32(s)))
        t = float(A.schedule(A.AdamWConfig(**c), torch.tensor(s)))
        assert t == pytest.approx(r, rel=1e-6, abs=1e-7), s
    tc = A.AdamWConfig(**c)
    assert float(A.schedule(tc, torch.tensor(5))) == pytest.approx(0.5)
    assert float(A.schedule(tc, torch.tensor(10))) == pytest.approx(
        1.0, abs=0.01)
    assert float(A.schedule(tc, torch.tensor(100))) == pytest.approx(
        0.1, abs=0.01)


def test_decay_skips_norms_and_integer_leaves():
    """Leaves the reference does not decay keep their value when the
    gradient is zero; decayed ones shrink."""
    _, tc, _, tp, _, _ = setup(MOE)
    zeros = map_tree(lambda p: torch.zeros_like(p)
                     if p.is_floating_point() else None, tp)
    cfg = A.AdamWConfig(warmup_steps=0, weight_decay=0.5)
    new, _, _ = A.apply(cfg, tp, zeros, A.init(tp))
    b = new["blocks"][0]["p0"]
    assert torch.equal(b["ln1"], tp["blocks"][0]["p0"]["ln1"])
    assert torch.equal(new["final_norm"], tp["final_norm"])
    assert not torch.equal(b["attn"]["wq"], tp["blocks"][0]["p0"]["attn"]
                           ["wq"])
    assert new["expert_perm"] is tp["expert_perm"]
    assert not A._decayable(("blocks", 0, "p0", "time_mix", "mu_r"))


def test_adamw_descends():
    """The same batch 8 times at lr 1e-3: the loss falls by more than 0.1
    (the reference's ``test_adamw_descends``)."""
    _, tc, _, tp, _, tb = setup("qwen3_4b")
    step = T.make_train_step(tc, A.AdamWConfig(lr=1e-3, warmup_steps=0))
    params, opt, losses = tp, A.init(tp), []
    for _ in range(8):
        params, opt, m = step(params, opt, tb)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1


def test_eval_step_matches_reference():
    rc, tc, rp, tp, nb, tb = setup("qwen3_4b")
    r = RT.make_eval_step(rc)(rp, nb)
    t = T.make_eval_step(tc)(tp, tb)
    assert _rel(t["loss"], r["loss"]) <= TOL
    assert not t["loss"].requires_grad


def test_promote_fp64_runs_the_step_in_fp64():
    """Inside ``promote_fp64`` the casts to fp32 of the loss, the model and
    AdamW ask for fp64: a step on fp64 params keeps every tensor fp64 and
    lands within fp32 rounding of the fp32 step."""
    _, tc, _, tp, _, tb = setup("qwen3_4b")
    c64 = dataclasses.replace(tc, dtype="float64")
    p64 = map_tree(lambda p: p.double() if p.is_floating_point() else p,
                   tp)
    step = T.make_train_step(tc, A.AdamWConfig(warmup_steps=0))
    with T.promote_fp64():
        l64, _, g64 = T.loss_and_grads(p64, tb, c64, remat=False)
        n64, o64, m64 = A.apply(A.AdamWConfig(warmup_steps=0), p64, g64,
                                A.init(p64))
    assert l64.dtype == m64["grad_norm"].dtype == torch.float64
    assert o64.mu["embed"].dtype == torch.float64
    n32, _, m32 = step(tp, A.init(tp), tb)
    assert abs(float(m32["loss"]) - float(l64)) <= 1e-5
    assert all(_rel(a.numpy(), b.numpy()) <= TOL for a, b in zip(
        flatten_tree(n32).values(), flatten_tree(n64).values()))


# ---------------------------------------------------------------------------
# data pipeline and shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3_4b", "paligemma_3b",
                                  "seamless_m4t_medium"])
def test_batch_for_shapes_and_determinism(arch):
    """The reference's batch layout (keys, shapes; labels = tokens shifted
    by one), a pure function of (seed, step), tokens in [1, vocab)."""
    rc, tc = r_base.load_smoke(arch), t_base.load_smoke(arch)
    rs, ts = r_base.ShapeConfig(*SHAPE), t_base.ShapeConfig(*SHAPE)
    ref = r_data.batch_for(rc, rs, 3)
    a = t_data.batch_for(tc, ts, 3, device=CPU)
    b = t_data.batch_for(tc, ts, 3, device=CPU)
    c = t_data.batch_for(tc, ts, 4, device=CPU)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 1 and int(a["tokens"].max()) < tc.vocab
    specs = t_data.input_specs(tc, ts)
    rspecs = r_data.input_specs(rc, rs)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in rspecs.items()}
    assert all(v.device.type == "meta" for v in specs.values())


def test_synth_tokens_follow_rule():
    """About half of the second tokens follow the fixed per-seed
    permutation of the first; the permutation does not depend on the
    step."""
    dc = t_data.DataConfig(vocab=512, seq_len=1, global_batch=4000, seed=1)
    perm = t_data._rng(1, t_data.PERM_STEP).permutation(512)
    for step in (0, 7):
        t = t_data.synth_tokens(dc, step)
        assert t.dtype == np.int32 and t.shape == (4000, 2)
        assert 0.45 < np.mean(t[:, 1] == perm[t[:, 0]]) < 0.55


def test_abstract_params_match_init_and_reference():
    """Meta tensors of the init's shapes and dtypes, no draw (the
    generator's stream is untouched); the full Qwen3-4B tree has the
    reference's leaves, unstacked."""
    for arch in t_base.ARCHS:
        cfg = t_base.load_smoke(arch)
        ab = flatten_tree(M.abstract_params(cfg))
        real = flatten_tree(M.init_params(cfg, device=CPU))
        assert list(ab) == list(real)
        for k, v in ab.items():
            assert v.device.type == "meta"
            assert (v.shape, v.dtype) == (real[k].shape, real[k].dtype), k
    full = M.abstract_params(t_base.load_config("qwen3_4b"))
    ref = RM.abstract_params(r_base.load_config("qwen3_4b"))
    flat = flatten_tree(full)
    n = 0
    for key, v in flat.items():
        path = tuple(int(s) if s.isdigit() else s for s in key.split("/"))
        r = ref[path[0]]
        for k in path[2:] if path[0] in STACKS else path[1:]:
            r = r[k]
        want = r.shape[1:] if path[0] in STACKS else r.shape
        assert tuple(v.shape) == tuple(want), key
        assert str(v.dtype).endswith(str(r.dtype)), key
        n += v.numel()
    assert n == sum(np.prod(x.shape) for x in jax.tree.leaves(ref))


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    t_launch.main(["--arch", "qwen3_4b", "--smoke", "--steps", "2", "--seq",
                   "16", "--batch", "2", "--device", "cpu", "--ckpt",
                   str(tmp_path), "--ckpt-every", "1"])
    assert "finished at step 2" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000001", "step_00000002"]
    # --mesh (A8b): a mesh of more than one rank needs a world of
    # processes (torchrun), --fsdp needs --mesh, and a 1 x 1 mesh starts a
    # one-rank world of its own and ends it
    with pytest.raises(RuntimeError, match="world of processes"):
        t_launch.main(["--arch", "qwen3_4b", "--smoke", "--mesh", "2,2",
                       "--device", "cpu"])
    with pytest.raises(SystemExit):
        t_launch.main(["--arch", "qwen3_4b", "--smoke", "--fsdp",
                       "--device", "cpu"])
    capsys.readouterr()
    out = t_launch.main(["--arch", "qwen3_4b", "--smoke", "--steps", "2",
                         "--seq", "16", "--batch", "2", "--device", "cpu",
                         "--mesh", "1,1", "--fsdp"])
    assert out["steps"] == 2
    assert "mesh=(data=1, model=1) fsdp" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
