"""The port's remaining compiled paths on the CPU: the captured train step
(``train.train_step.GraphedTrainStep``, the counterpart of the reference's
``jax.jit(step, donate_argnums=(0, 1))``), its fixed-mask form, the
captured prefill and admission (``serve.engine.GraphedPrefill`` and
``GraphedAdmit``: ``jitted_prefill``, ``jitted_admit``), the sampled
graphed decode step and the captured FFN probe (``GraphedFfnStats``:
``jitted_ffn_stats``). On CPU tensors a ``graphs.CapturedGraph`` calls its
body directly, so these tests hold the bodies: bitwise equal to the eager
paths they replace and, where the reference has the path, within rel err
1e-5 of it (or equal, for tokens and counters) on the same weights. The
capture and the replays run on the card (``tests/test_torch_gpu.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import base as r_base
from repro.data import pipeline as r_data
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.serve import Request as RRequest
from repro.serve import Scheduler as RScheduler
from repro.serve.engine import jitted_ffn_stats
from repro.sparsity.sparse_ffn import sparsify_model as r_sparsify_model
from repro.train import train_step as RT
from repro_torch.configs import base as t_base
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import batch_for
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw as A
from repro_torch.serve import (GraphedAdmit, GraphedFfnStats,
                               GraphedPrefill, GraphedServeStep, Request,
                               Scheduler, make_serve_step)
from repro_torch.serve.engine import prefill_lane, write_lane
from repro_torch.sparsity import pruning
from repro_torch.sparsity.sparse_ffn import sparsify_model
from repro_torch.train import train_step as T
from repro_torch.train.loop import TrainLoopConfig, train
from repro_torch.tree import flatten_tree, leaves, map_tree

CPU = torch.device("cpu")
TOL = 1e-5
MOE = "moonshot_v1_16b_a3b"
SHAPE = ("t", 32, 4, "train")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _tree_equal(a, b) -> bool:
    fa, fb = flatten_tree(a), flatten_tree(b)
    return list(fa) == list(fb) and all(
        fa[k].dtype == fb[k].dtype and torch.equal(_bits(fa[k]), _bits(fb[k]))
        for k in fa)


def _clone(tree):
    return map_tree(torch.clone, tree)


@functools.lru_cache(maxsize=None)
def _train_setup(arch):
    """(ref cfg, port cfg, ref params, port params, numpy batches of steps
    0-2, port batches): the smoke config's reference weights carried
    across."""
    rc, tc = r_base.load_smoke(arch), t_base.load_smoke(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   rc)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    nbs = [{k: np.asarray(v) for k, v in r_data.batch_for(
        rc, r_base.ShapeConfig(*SHAPE), i).items()} for i in range(3)]
    tbs = [{k: torch.from_numpy(v.copy()) for k, v in nb.items()}
           for nb in nbs]
    return rc, tc, rp, tp, nbs, tbs


# ---------------------------------------------------------------------------
# the captured train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,microbatches", [
    ("qwen3_4b", 1), ("qwen3_4b", 2), (MOE, 1)])
def test_graphed_train_step_bitwise_donated_step(arch, microbatches):
    """Three steps of the captured step's body from one state: params,
    moments, the step counter and the metrics bitwise equal to
    ``make_train_step(donate=True)``'s, the state's tensors kept (updated
    in place, the counter too); the first step's loss, params and moments
    within 1e-5 of the reference's jitted step on the same batch."""
    rc, tc, rp, tp, nbs, tbs = _train_setup(arch)
    cfg = A.AdamWConfig(warmup_steps=1)
    eager = T.make_train_step(tc, cfg, microbatches=microbatches,
                              donate=True)
    graphed = T.GraphedTrainStep(tc, cfg, microbatches=microbatches)
    ep, eo = _clone(tp), A.init(_clone(tp))
    gp, go = _clone(tp), A.init(_clone(tp))
    ptrs = [t.data_ptr() for t in leaves((gp, go))]
    for i in range(3):
        ep, eo, em = eager(ep, eo, tbs[i])
        gp, go, gm = graphed(gp, go, tbs[i])
        assert _tree_equal((gp, go, gm), (ep, eo, em)), i
        assert int(go.step) == i + 1
        if i == 0 and arch == "qwen3_4b":
            rp2, ro2, rm = jax.jit(RT.make_train_step(
                rc, RA.AdamWConfig(warmup_steps=1),
                microbatches=microbatches))(rp, RA.init(rp), nbs[0])
            for k in ("loss", "grad_norm", "lr"):
                assert _rel(gm[k], rm[k]) <= TOL, k
            assert _rel(gp["embed"], rp2["embed"]) <= TOL
            assert _rel(go.mu["embed"], ro2.mu["embed"]) <= TOL
            assert _rel(go.nu["embed"], ro2.nu["embed"]) <= TOL
    assert [t.data_ptr() for t in leaves((gp, go))] == ptrs
    assert len(graphed.graphs) == 1


def test_donated_adamw_advances_the_counter_in_place():
    """``apply(donate=True)`` writes the step counter in place (a replayed
    graph reads and writes one buffer) with ``lr`` and the bias
    corrections from it; ``donate=False`` leaves the given counter."""
    _, tc, _, tp, _, _ = _train_setup("qwen3_4b")
    grads = map_tree(lambda p: torch.ones_like(p) * 1e-3, tp)
    opt = A.init(_clone(tp))
    counter = opt.step
    new_p, new_o, m = A.apply(A.AdamWConfig(warmup_steps=4), tp, grads, opt)
    assert int(opt.step) == 0 and int(new_o.step) == 1
    params = _clone(tp)
    got_p, got_o, gm = A.apply(A.AdamWConfig(warmup_steps=4), params, grads,
                               opt, donate=True)
    assert got_o.step is counter and int(counter) == 1
    assert _tree_equal((got_p, got_o, gm), (new_p, new_o, m))


def test_train_compiled_resume_bitwise_uninterrupted(tmp_path):
    """``train(compiled=True)`` (the default): 4 steps with a checkpoint
    every 2, then a fresh run to 6 that resumes from step 4 into new
    tensors, bitwise equal to 6 steps in one run and to the eager loop."""
    cfg = t_base.load_smoke("qwen3_4b")
    shape = t_base.ShapeConfig(*SHAPE)
    d = str(tmp_path / "ck")
    lc = TrainLoopConfig(steps=4, ckpt_every=2, ckpt_dir=d, log_every=100)
    first = train(cfg, shape, lc, device=CPU)
    assert first.step == 4
    resumed = train(cfg, shape, dataclasses.replace(lc, steps=6),
                    device=CPU)
    assert resumed.step == 6 and int(resumed.opt.step) == 6
    one = train(cfg, shape, TrainLoopConfig(steps=6, log_every=100),
                device=CPU)
    eager = train(cfg, shape, TrainLoopConfig(steps=6, log_every=100),
                  device=CPU, compiled=False)
    assert _tree_equal((resumed.params, resumed.opt), (one.params, one.opt))
    assert _tree_equal((one.params, one.opt), (eager.params, eager.opt))


def test_graphed_pruned_step_equals_apply_masks():
    """The captured fixed-mask step (``make_pruned_train_step`` of a
    ``GraphedTrainStep``) over 3 steps: bitwise the eager wrapper's
    ``apply_masks`` of each step's params, the params kept in place (never
    new tensors), every pruned weight exactly 0."""
    _, tc, _, tp, _, tbs = _train_setup("qwen3_4b")
    masks = pruning.prune_masks(tp, pruning.PruneConfig(density=0.5,
                                                        min_size=512))
    cfg = A.AdamWConfig(warmup_steps=0)
    start = pruning.apply_masks(tp, masks)
    eager = pruning.make_pruned_train_step(T.make_train_step(tc, cfg), masks)
    graphed = pruning.make_pruned_train_step(T.GraphedTrainStep(tc, cfg),
                                             masks)
    assert isinstance(graphed, T.GraphedTrainStep)
    assert graphed.masks is masks
    ep, eo = start, A.init(start)
    gp, go = _clone(start), A.init(start)
    ptrs = [t.data_ptr() for t in leaves(gp)]
    for i in range(3):
        ep, eo, em = eager(ep, eo, tbs[i])
        gp, go, gm = graphed(gp, go, tbs[i])
        assert _tree_equal((gp, go, gm), (ep, eo, em)), i
    assert [t.data_ptr() for t in leaves(gp)] == ptrs
    zeros = []
    map_tree(lambda p, m: None if m is None else zeros.append(
        bool((p[m == 0] == 0).all())), gp, masks)
    assert len(zeros) == 6 and all(zeros)


# ---------------------------------------------------------------------------
# the flash attention scale
# ---------------------------------------------------------------------------
class _ScaleAsTensor(TorchFunctionMode):
    """``tensor * python float`` computed as the product with a 0-d tensor
    of the tensor's dtype (how ``_flash_sdpa`` scaled q before);
    ``hits`` counts the products it changed."""
    hits = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.mul, torch.Tensor.__mul__) \
                and isinstance(args[1], float):
            self.hits += 1
            args = (args[0], torch.tensor(args[1], dtype=args[0].dtype,
                                          device=args[0].device))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 80, 128])
def test_flash_scale_bitwise_as_before(dtype, dh):
    """``_flash_sdpa`` scales q by the scale rounded to q's dtype as a
    Python number: its output bitwise what the 0-d tensor of q's dtype
    gave (that tensor was a host-to-device copy a capture cannot take)."""
    g = torch.Generator().manual_seed(dh)
    q = torch.randn((2, 9, 4, dh), generator=g).to(dtype)
    k = torch.randn((2, 9, 2, dh), generator=g).to(dtype)
    v = torch.randn((2, 9, 2, dh), generator=g).to(dtype)
    got = L._flash_sdpa(q, k, v, 2, kv_chunk=4)
    with _ScaleAsTensor() as mode:
        before = L._flash_sdpa(q, k, v, 2, kv_chunk=4)
    assert mode.hits == 1                  # q * scale, and nothing else
    assert torch.equal(_bits(got), _bits(before))
    s = 1.0 / dh ** 0.5
    assert torch.equal(_bits(q * torch.tensor(s, dtype=dtype).item()),
                       _bits(q * torch.tensor(s, dtype=dtype)))


# ---------------------------------------------------------------------------
# serving: prefill, admission, the sampled step, the probe
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lm():
    """Sparse Qwen3 smoke widened to d_model 256, d_ff 640 (fp32), packed
    by each package at density 0.35 over 4 shards: (ref cfg, port cfg, ref
    params, port params)."""
    extra = dict(sparse_ffn=True, d_model=256, d_ff=640)
    rcfg = dataclasses.replace(r_base.load_smoke("qwen3_4b"), **extra)
    tcfg = dataclasses.replace(t_base.load_smoke("qwen3_4b"), **extra)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    return (rcfg, tcfg, r_sparsify_model(rp, rcfg, density=0.35,
                                         num_shards=4),
            sparsify_model(tp, tcfg, density=0.35, num_shards=4))


def _prompts(cfg, B=2, S=6, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S))


def test_graphed_prefill_writes_the_callers_cache():
    """``GraphedPrefill``: the last logits and the cache bitwise
    ``prefill``'s, written into the cache given (its own tensors, so
    another graph may adopt them); one graph per prompt length and batch
    width."""
    _, tcfg, _, tp = _lm()
    pre = GraphedPrefill(tcfg)
    for B, S in ((2, 6), (2, 6), (1, 6), (2, 5)):
        toks = torch.as_tensor(_prompts(tcfg, B, S))
        cache = M.init_cache(tcfg, B, 12, device=CPU)
        before = leaves(cache)
        want_l, want_c = M.prefill(tp, tcfg, toks, _clone(cache))
        last, got = pre(tp, toks, cache)
        assert torch.equal(last, want_l) and _tree_equal(got, want_c)
        assert all(a is b for a, b in zip(leaves(got), before))
    assert len(pre.graphs) == 3


def test_admission_body_with_device_slot_equals_prefill_and_write_lane():
    """``GraphedAdmit`` with the slot a tensor (and an int): the first
    token and the cache bitwise ``prefill_lane`` then ``write_lane`` on a
    dirty cache, written in place; one graph per prompt length, whatever
    the slot."""
    _, tcfg, _, tp = _lm()
    admit = GraphedAdmit(tcfg, 12)
    cache = map_tree(lambda t: torch.randn_like(t), M.init_cache(
        tcfg, 3, 12, device=CPU))
    want = _clone(cache)
    before = leaves(cache)
    for i, (slot, S) in enumerate(((2, 6), (torch.tensor(0), 6),
                                   (torch.tensor([1]), 4))):
        prompt = _prompts(tcfg, 1, S, seed=i)[0]
        first, cache = admit(tp, cache, prompt, slot)
        tok, lane = prefill_lane(tp, tcfg, 12, torch.as_tensor(prompt)[None])
        write_lane(want, lane, int(slot))
        assert torch.equal(first, tok) and _tree_equal(cache, want), i
        assert all(a is b for a, b in zip(leaves(cache), before))
    assert len(admit.graphs) == 2
    with pytest.raises(ValueError, match="decoder-only"):
        GraphedAdmit(t_base.load_smoke("seamless_m4t_medium"), 12)


def test_compiled_scheduler_admits_through_the_graph_as_the_reference():
    """``Scheduler(compiled=True)`` admits through ``GraphedAdmit`` (one
    graph per prompt length) and probes through ``GraphedFfnStats``: its
    tokens, stats and probe equal the reference ``Scheduler``'s and the
    eager scheduler's, the caches bitwise."""
    rcfg, tcfg, rp, tp = _lm()
    prompts = [_prompts(tcfg, 1, S, seed=S)[0] for S in (6, 4, 6, 5)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new=4, arrival=i)
                for i, p in enumerate(prompts)]
    rs = RScheduler(rcfg, rp, num_slots=2, max_len=16,
                    verify_artifacts=False)
    want = rs.run(reqs(RRequest), probe_ffn=True)
    graphed = Scheduler(tcfg, tp, num_slots=2, max_len=16)
    eager = Scheduler(tcfg, tp, num_slots=2, max_len=16, compiled=False)
    got = graphed.run(reqs(Request), probe_ffn=True)
    assert got == eager.run(reqs(Request), probe_ffn=True) == want
    assert graphed.stats.prefills == rs.stats.prefills == 4
    assert graphed.ffn_probe == eager.ffn_probe
    assert set(graphed.ffn_probe) == set(rs.ffn_probe)
    for k, v in rs.ffn_probe.items():
        assert graphed.ffn_probe[k] == v, k
    assert _tree_equal(graphed.cache, eager.cache)
    assert len(graphed._admit_fn.graphs) == 3             # prompts 6, 4, 5
    assert len(graphed._stats_fn.graphs) == 1
    assert len(graphed.captured_graphs()) == 5
    assert eager.captured_graphs() == []


def test_probe_counters_equal_reference_jitted_ffn_stats():
    """``GraphedFfnStats`` on one prefilled cache with one lane parked:
    every counter equal to the reference's ``jitted_ffn_stats``, 0-d
    tensors on the params' device, the cache untouched; dense params give
    zeros of the three tile-MAC keys."""
    rcfg, tcfg, rp, tp = _lm()
    B, S = 2, 6
    toks = _prompts(tcfg, B, S)
    rc = RM.init_cache(rcfg, B, 12)
    _, rc = RM.prefill(rp, rcfg, jnp.asarray(toks), rc)
    tc = M.init_cache(tcfg, B, 12, device=CPU)
    _, tc = M.prefill(tp, tcfg, torch.as_tensor(toks), tc)
    tok = np.array([[3], [5]])
    pos = np.array([S, S])
    active = np.array([True, False])
    want = jitted_ffn_stats(rcfg)(rp, rc, jnp.asarray(tok, jnp.int32),
                                  jnp.asarray(pos, jnp.int32),
                                  jnp.asarray(active))
    snapshot = _clone(tc)
    got = GraphedFfnStats(tcfg)(tp, tc, tok, pos, active)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == () and got[k].device == CPU
        assert float(got[k]) == float(v), k
    assert _tree_equal(tc, snapshot)
    dense = M.init_params(t_base.load_smoke("qwen3_4b"), seed=0, device=CPU)
    dcfg = t_base.load_smoke("qwen3_4b")
    z = GraphedFfnStats(dcfg)(dense, M.init_cache(dcfg, 2, 8, device=CPU),
                              tok, pos, active)
    assert {k: float(v) for k, v in z.items()} == {
        "executed": 0.0, "weight_tile_macs": 0.0, "dense_tile_macs": 0.0}


def test_sampled_pick_draws_as_multinomial():
    """The sampled pick (``argmax(p / q)``, ``q ~ Exp(1)``) draws the
    tokens and advances the generator as ``torch.multinomial(p, 1)``."""
    from repro_torch.serve.engine import _pick
    logits = torch.randn((4, 300), generator=torch.Generator().manual_seed(1))
    for seed in range(20):
        a, b = (torch.Generator().manual_seed(seed) for _ in range(2))
        want = torch.multinomial(torch.softmax(logits, -1), 1,
                                 generator=a)[:, 0]
        assert torch.equal(_pick(logits, False, b), want), seed
        assert torch.equal(a.get_state(), b.get_state())


def test_sampled_graphed_step_equals_eager_on_one_seed():
    """The sampled decode step's body (``GraphedServeStep(greedy=False)``
    with an ``rng``) over 4 steps: tokens and caches bitwise the eager
    step's on the same seed, the generators left in the same state; a
    graph per generator; greedy without an ``rng``."""
    _, tcfg, _, tp = _lm()
    B, S = 2, 6
    toks = torch.as_tensor(_prompts(tcfg, B, S))
    cache = M.init_cache(tcfg, B, 12, device=CPU)
    last, cache = M.prefill(tp, tcfg, toks, cache)
    eager_step = make_serve_step(tcfg, greedy=False)
    graphed = GraphedServeStep(tcfg, greedy=False)
    ec, gc = _clone(cache), _clone(cache)
    eg, gg = (torch.Generator().manual_seed(7) for _ in range(2))
    tok = torch.argmax(last, -1)[:, None]
    etok = gtok = tok
    for i in range(4):
        pos = torch.full((B,), S + i, dtype=torch.long)
        etok, ec = eager_step(tp, ec, etok, pos, None, eg)
        gtok, gc = graphed(tp, gc, gtok, pos, None, gg)
        assert torch.equal(gtok, etok) and _tree_equal(gc, ec), i
    assert torch.equal(eg.get_state(), gg.get_state())
    other = torch.Generator().manual_seed(7)
    graphed(tp, _clone(cache), tok, torch.full((B,), S, dtype=torch.long),
            None, other)
    assert len(graphed.graphs) == 2
    want = M.decode_step(tp, tcfg, tok, cache, torch.full(
        (B,), S, dtype=torch.long))[0][:, 0].argmax(-1)[:, None]
    got, _ = graphed(tp, _clone(cache), tok,
                     torch.full((B,), S, dtype=torch.long))
    assert torch.equal(got, want)
