"""The port's compiled serving paths on the CPU: the graph-facing decode
step (``serve.engine.GraphedServeStep``, the counterpart of the reference's
``jitted_serve_step``) under ``Scheduler(compiled=True)`` and
``generate(compiled=True)``, and the captured whole-net forward
(``vision.model.graphed_forward``, the counterpart of the jitted
``compile_forward``). On CPU tensors a :class:`repro_torch.graphs.
CapturedGraph` calls its body directly, so these tests hold the bodies:
bitwise equal to the port's eager step and forward, and within rel err
1e-5 (logits; greedy tokens equal) of the reference on the same weights
(``convert.params_from_reference``), its sparse FFN kernels run with
``interpret=True`` as in ``tests/test_torch_lm.py``. Smoke configs in fp32:
sparse Qwen3 (widened to d_model 256, d_ff 640), sparse RWKV6, Moonlight
(MoE), Jamba (Mamba) and sparse SeamlessM4T (encoder-decoder). The capture
itself, replay and launch tallies run on the card
(``tests/test_torch_gpu.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import model as RM
from repro.serve import Request as RRequest
from repro.serve import Scheduler as RScheduler
from repro.serve.engine import generate as r_generate
from repro.serve.engine import jitted_serve_step
from repro.sparsity.sparse_ffn import sparsify_model as r_sparsify_model
from repro.vision import build_vision_model as r_build
from repro.vision import forward as r_forward
from repro.launch.vision import blob_images as r_blob_images
from repro_torch import graphs
from repro_torch.configs import base as t_base
from repro_torch.convert import params_from_reference
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import (GraphedServeStep, Request, Scheduler,
                               generate, make_serve_step)
from repro_torch.sparsity.sparse_ffn import sparsify_model
from repro_torch.tree import leaves, map_tree
from repro_torch.vision import (build_vision_model, compile_forward,
                                graphed_forward)

CPU = torch.device("cpu")
TOL = 1e-5
CASES = ["qwen_wide", "rwkv6_3b", "moonshot_v1_16b_a3b",
         "jamba_1_5_large_398b", "seamless_m4t_medium"]
DECODER_ONLY = CASES[:4]
SPARSE = ("qwen_wide", "rwkv6_3b", "seamless_m4t_medium")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _models(case):
    """(ref cfg, port cfg, ref params, port params): the smoke config's
    reference weights from PRNGKey(0) carried across; the sparse cases
    packed by each package at density 0.35 over 4 shards."""
    arch = "qwen3_4b" if case == "qwen_wide" else case
    rcfg, tcfg = r_base.load_smoke(arch), t_base.load_smoke(arch)
    if case == "qwen_wide":
        extra = dict(sparse_ffn=True, d_model=256, d_ff=640)
        rcfg = dataclasses.replace(rcfg, **extra)
        tcfg = dataclasses.replace(tcfg, **extra)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    if case in SPARSE:
        rp = r_sparsify_model(rp, rcfg, density=0.35, num_shards=4)
        tp = sparsify_model(tp, tcfg, density=0.35, num_shards=4)
    return rcfg, tcfg, rp, tp


def _src(cfg, B):
    """Stub encoder frames of an encoder-decoder (None otherwise)."""
    if not cfg.encoder_layers:
        return None
    rng = np.random.default_rng(1)
    return (0.02 * rng.normal(size=(B, 4, cfg.d_model))).astype(np.float32)


def _prompts(cfg, B=2, S=6):
    rng = np.random.default_rng(0)
    return rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)


def _requests(cfg, cls, n=3, prompt_len=6, max_new=5, stagger=1):
    toks = _prompts(cfg, n, prompt_len)
    return [cls(rid=i, prompt=toks[i], max_new=max_new, arrival=i * stagger)
            for i in range(n)]


def _tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("case", CASES)
def test_graphed_step_bitwise_eager_and_matches_reference(case):
    """Four decode steps from one prefilled cache: the graphed step's
    tokens, logits and cache bitwise equal to the eager ``decode_step``'s
    (all lanes live against ``active=None``); logits within 1e-5 of the
    reference's ``decode_step`` and tokens equal to its
    ``jitted_serve_step``'s."""
    rcfg, tcfg, rp, tp = _models(case)
    B, S, steps = 2, 6, 4
    toks = _prompts(rcfg, B, S)
    src = _src(rcfg, B)
    enc = 0 if src is None else src.shape[1]
    rc = RM.init_cache(rcfg, B, S + steps + 1, enc_len=enc)
    tc = M.init_cache(tcfg, B, S + steps + 1, enc_len=enc, device=CPU)
    if src is not None:
        rc = RM.prefill_cache(rp, rcfg, rc, RM.encode(rp, jnp.asarray(src),
                                                      rcfg))
        tc = M.prefill_cache(tp, tcfg, tc, M.encode(tp, _t(src), tcfg))
    rl, rc = RM.prefill(rp, rcfg, jnp.asarray(toks), rc)
    tl, tc = M.prefill(tp, tcfg, _t(toks).long(), tc)
    assert _rel(tl, rl) <= TOL
    eager_cache = map_tree(torch.clone, tc)
    graph_cache = map_tree(torch.clone, tc)
    step = GraphedServeStep(tcfg)
    r_step = jitted_serve_step(rcfg, True)
    tok = torch.argmax(tl, -1)[:, None]
    rtok = jnp.asarray(tok.numpy(), jnp.int32)
    for i in range(steps):
        pos = torch.full((B,), S + i, dtype=torch.long)
        el, eager_cache = M.decode_step(tp, tcfg, tok, eager_cache, pos)
        nxt, graph_cache = step(tp, graph_cache, tok, pos)
        assert torch.equal(step.last_logits, el[:, 0]), i
        assert torch.equal(nxt, torch.argmax(el[:, 0], -1)[:, None]), i
        assert _tree_equal(graph_cache, eager_cache), i
        rpos = jnp.full((B,), S + i, jnp.int32)
        rl, _ = RM.decode_step(rp, rcfg, rtok, rc, rpos)
        rnxt, rc = r_step(rp, rc, rtok, rpos)
        assert _rel(step.last_logits, np.asarray(rl)[:, 0]) <= TOL, i
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(rnxt))
        tok, rtok = nxt, rnxt
    assert len(step.graphs) == 1


@pytest.mark.parametrize("case", CASES)
def test_graphed_generate_bitwise_eager_and_reference(case):
    rcfg, tcfg, rp, tp = _models(case)
    toks = _prompts(rcfg)
    src = _src(rcfg, 2)
    kw = {} if src is None else {"src_embeds": _t(src)}
    rkw = {} if src is None else {"src_embeds": jnp.asarray(src)}
    got = generate(tp, tcfg, _t(toks).long(), 6, **kw)
    eager = generate(tp, tcfg, _t(toks).long(), 6, compiled=False, **kw)
    want = np.asarray(r_generate(rp, rcfg, jnp.asarray(toks), 6, **rkw))
    assert torch.equal(got, eager)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", DECODER_ONLY)
def test_graphed_scheduler_bitwise_eager_and_reference(case):
    rcfg, tcfg, rp, tp = _models(case)
    rs = RScheduler(rcfg, rp, num_slots=2, max_len=16,
                    verify_artifacts=False)
    want = rs.run(_requests(rcfg, RRequest))
    graphed = Scheduler(tcfg, tp, num_slots=2, max_len=16, compiled=True)
    eager = Scheduler(tcfg, tp, num_slots=2, max_len=16, compiled=False)
    got = graphed.run(_requests(tcfg, Request))
    assert got == eager.run(_requests(tcfg, Request)) == want
    assert (graphed.stats.engine_steps, graphed.stats.tokens,
            graphed.stats.idle_lane_steps, graphed.done_at) == \
        (rs.stats.engine_steps, rs.stats.tokens, rs.stats.idle_lane_steps,
         rs.done_at)
    assert _tree_equal(graphed.cache, eager.cache)
    assert len(graphed._step_fn.graphs) == 1           # one batch width


def test_scheduler_cache_written_in_place():
    """Admission, the step and ``reset_slots`` write into the cache the
    graph adopted (the same tensors throughout); a freed lane reads as
    zeros, and a readmitted lane holds its prompt's rows and zeros after
    them."""
    _, tcfg, _, tp = _models("qwen_wide")
    sch = Scheduler(tcfg, tp, num_slots=2, max_len=16, compiled=True)
    before = leaves(sch.cache)
    sch.run(_requests(tcfg, Request, n=3, max_new=4, stagger=2))
    after = leaves(sch.cache)
    assert all(a is b for a, b in zip(before, after))
    assert all(bool((t == 0).all()) for t in after)     # every lane freed
    prompt = _prompts(tcfg, 1, 5)[0]
    sch.submit(Request(9, prompt, 3))
    sch._admit_ready()                                  # no decode step yet
    slot = int(np.nonzero(sch.slot_req == 9)[0][0])
    lane = M.init_cache(tcfg, 1, 16, device=CPU)
    _, lane = M.prefill(tp, tcfg, _t(prompt).long()[None], lane)
    for big, one in zip(leaves(sch.cache), leaves(lane)):
        assert torch.equal(big[slot], one[0])
        assert bool((big[slot, 5:] == 0).all())
        assert bool((big[1 - slot] == 0).all())
    assert all(a is b for a, b in zip(before, leaves(sch.cache)))


def test_graphed_generate_samples_as_eager():
    """Sampling on the graphed path (the refusal of ``rng`` is gone):
    ``generate(compiled=True, rng=...)`` and a held sampled step give the
    eager run's tokens on the same seed, batch width 2, and leave the
    generator where the eager run leaves it; the eager step keeps
    sampling."""
    _, tcfg, _, tp = _models("qwen_wide")
    toks = _t(_prompts(tcfg)).long()
    gens = [torch.Generator().manual_seed(0) for _ in range(3)]
    want = generate(tp, tcfg, toks, 5, greedy=False, rng=gens[0],
                    compiled=False)
    got = generate(tp, tcfg, toks, 5, greedy=False, rng=gens[1])
    held = GraphedServeStep(tcfg, greedy=False)
    again = generate(tp, tcfg, toks, 5, greedy=False, rng=gens[2],
                     step=held)
    assert want.shape == (2, 11)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert all(torch.equal(g.get_state(), gens[0].get_state())
               for g in gens[1:])
    assert len(held.graphs) == 1 and len(held.prefill.graphs) == 1
    cache = M.init_cache(tcfg, 2, 8, device=CPU)
    nxt, _ = make_serve_step(tcfg, greedy=False)(
        tp, cache, toks[:, :1], torch.zeros(2, dtype=torch.long), None,
        gens[0])
    assert nxt.shape == (2, 1)


def test_graph_per_batch_width_on_a_held_step():
    """A :class:`GraphedServeStep` the caller holds and hands to
    ``generate`` keeps one graph per cache geometry: a second call of the
    same geometry reuses its graph, a new batch width adds one."""
    _, tcfg, _, tp = _models("qwen_wide")
    toks = _t(_prompts(tcfg, 4, 6)).long()
    step = GraphedServeStep(tcfg)
    a = generate(tp, tcfg, toks[:2], 4, step=step)
    assert len(step.graphs) == 1
    assert torch.equal(generate(tp, tcfg, toks[:2], 4, step=step), a)
    assert len(step.graphs) == 1
    b = generate(tp, tcfg, toks, 4, step=step)
    assert len(step.graphs) == 2
    assert torch.equal(b[:2], a)
    assert torch.equal(generate(tp, tcfg, toks[:2], 4), a)   # a new step
    with pytest.raises(ValueError, match="step"):
        generate(tp, tcfg, toks[:2], 4, step=step, compiled=False)
    step = GraphedServeStep(tcfg)
    for B in (1, 3):
        step(tp, M.init_cache(tcfg, B, 8, device=CPU),
             torch.ones((B, 1), dtype=torch.long),
             torch.zeros(B, dtype=torch.long))
    assert len(step.graphs) == 2


def test_rebound_params_leaf_gets_a_new_graph():
    """The step's graphs are keyed on every params leaf's address: after
    ``params["expert_perm"]`` is rebound the step captures a new graph,
    and its logits are the eager step's on the new params (which differ
    from the old ones')."""
    _, tcfg, _, tp = _models("moonshot_v1_16b_a3b")
    params = dict(tp)
    toks = _t(_prompts(tcfg)).long()
    cache = M.init_cache(tcfg, 2, 8, device=CPU)
    _, cache = M.prefill(params, tcfg, toks[:, :4], cache)
    pos = torch.full((2,), 4, dtype=torch.long)
    step = GraphedServeStep(tcfg)
    logits = []
    for perm in (params["expert_perm"], params["expert_perm"].flip(0)):
        params["expert_perm"] = perm
        want, _ = M.decode_step(params, tcfg, toks[:, 4:5], cache, pos)
        step(params, map_tree(torch.clone, cache), toks[:, 4:5], pos)
        assert torch.equal(step.last_logits, want[:, 0])
        logits.append(step.last_logits.clone())
    assert len(step.graphs) == 2
    assert not torch.equal(logits[0], logits[1])


def test_captured_graph_on_cpu_calls_the_body():
    calls = []

    def body(x, tree):
        calls.append(1)
        return x * 2 + tree["y"][0]

    g = graphs.CapturedGraph(body, CPU, "cpu body")
    x, y = torch.arange(4.0), torch.ones(4)
    for _ in range(3):
        assert torch.equal(g(x, {"y": [y]}), x * 2 + y)
    assert len(calls) == 3 and g.replays == 0 and g.graph is None
    assert [t.shape for t in leaves({"a": [x], "b": (y,)})] \
        == [x.shape, y.shape]
    with pytest.raises(TypeError):
        leaves({"a": 3})


def test_moe_expert_counts_equal_bincount():
    """The capture-safe expert count (a scatter of ones into a fixed [E])
    gives the bincount formula's aux loss and the same outputs, bitwise,
    for the moonshot, arctic and jamba smoke configs at seed 0."""
    for arch in ("moonshot_v1_16b_a3b", "arctic_480b",
                 "jamba_1_5_large_398b"):
        cfg = t_base.load_smoke(arch)
        params = M.init_params(cfg, seed=0, device=CPU)
        bp = next(b for period in params["blocks"] for b in period.values()
                  if "moe" in b)
        x = torch.randn((2, 7, cfg.d_model),
                        generator=torch.Generator().manual_seed(0))
        perm = params["expert_perm"]
        y, aux = L.moe_ffn(bp["moe"], x, cfg, perm)
        probs, _, ids = L.moe_route(bp["moe"], x.reshape(-1, cfg.d_model),
                                    cfg, perm)
        E, T, K = cfg.moe.num_experts, 14, cfg.moe.top_k
        ce = torch.bincount(ids.reshape(-1), minlength=E).float() / (T * K)
        want = E * torch.sum(probs.mean(0) * ce)
        assert torch.equal(aux, want), arch
        y2, aux2 = L.moe_ffn(bp["moe"], x, cfg, perm)
        assert torch.equal(y, y2) and torch.equal(aux, aux2), arch


@pytest.mark.parametrize("pattern", ["chunk", "unstructured"])
def test_graphed_forward_on_cpu_bitwise_eager_and_reference(pattern):
    r = r_build("VGGNet", density=0.334, num_layers=3, pattern=pattern)
    t = build_vision_model("VGGNet", density=0.334, num_layers=3,
                           pattern=pattern, device=CPU)
    x = r_blob_images(np.random.default_rng(0), 2, 20, 0.4)
    eager = compile_forward(t)(torch.as_tensor(x))
    fwd = graphed_forward(t)
    assert fwd is graphed_forward(t)                    # cached on the model
    for _ in range(2):
        assert torch.equal(fwd(torch.as_tensor(x)), eager)
    rout, _ = r_forward(r, jnp.asarray(x), executor="xla")
    assert _rel(eager.numpy(), rout) <= TOL
