"""Port parity, the LM serving slice: configs, ``sparsify_model``, the
weight carry-over of ``convert.params_from_reference``, ``forward`` /
``prefill`` / ``decode_step`` logits and ``Scheduler`` greedy tokens and
FFN probe of ``repro_torch`` against the JAX reference on the same
weights, and the port's own invariants (sparse == dense at density 1.0,
batched == solo). Small sizes: the 2-layer smoke configs of Qwen3-4B
(gated SwiGLU) and Nemotron-4 (squared ReLU), and a widened Qwen3 smoke
(d_model 256, d_ff 640) whose FFN has several chunks and n-blocks and
pads K."""
import dataclasses
import functools
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import model as RM
from repro.serve import Request as RRequest
from repro.serve import Scheduler as RScheduler
from repro.sparsity.sparse_ffn import sparsify_model as r_sparsify_model
from repro_torch.configs import base as t_base
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as t_launch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import (Request, Scheduler, generate,
                               make_prefill_fn, reset_slots)
from repro_torch.sparsity.sparse_ffn import sparsify_model
from repro_torch.tree import map_tree

CPU = torch.device("cpu")
CASES = ["qwen3_4b", "nemotron_4_340b", "qwen_wide"]
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _cfgs(case, sparse=True):
    arch = "qwen3_4b" if case == "qwen_wide" else case
    rc, tc = r_base.load_smoke(arch), t_base.load_smoke(arch)
    extra = dict(sparse_ffn=sparse)
    if case == "qwen_wide":
        extra.update(d_model=256, d_ff=640)
    return dataclasses.replace(rc, **extra), dataclasses.replace(tc, **extra)


@functools.lru_cache(maxsize=None)
def _models(case, density=0.35):
    """(ref cfg, port cfg, ref params, ref sparse params, port sparse
    params): the port packs the carried-over dense weights itself."""
    rcfg, tcfg = _cfgs(case)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    rps = r_sparsify_model(rp, rcfg, density=density, num_shards=4)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    tps = sparsify_model(tp, tcfg, density=density, num_shards=4)
    return rcfg, tcfg, rp, rps, tps


def _requests(cfg, cls, n=3, prompt_len=6, max_new=5, stagger=1):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (n, prompt_len)).astype(np.int32)
    return [cls(rid=i, prompt=prompts[i], max_new=max_new,
                arrival=i * stagger) for i in range(n)]


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", t_base.ARCHS)
@pytest.mark.parametrize("which", ["load_config", "load_smoke"])
def test_configs_equal_reference(arch, which):
    r = getattr(r_base, which)(arch)
    t = getattr(t_base, which)(arch)
    rd, td = dataclasses.asdict(r), dataclasses.asdict(t)
    assert td == rd
    assert (t.padded_vocab, t.periods) == (r.padded_vocab, r.periods)


def test_full_qwen3_4b_is_full_width():
    cfg = t_base.load_config("qwen3_4b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.padded_vocab) == \
        (36, 2560, 9728, 32, 8, 128, 152064)
    assert cfg.qk_norm and cfg.tie_embeddings and cfg.dtype == "bfloat16"
    # every reference arch loads (tests/test_torch_families.py runs them);
    # an unknown name raises
    assert t_base.load_config("jamba_1_5_large_398b").family == "hybrid"
    with pytest.raises(ValueError):
        t_base.load_config("llama_7b")


def test_full_rwkv6_3b_is_full_width():
    cfg = t_base.load_config("rwkv6_3b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.d_head,
            cfg.vocab, cfg.padded_vocab) == \
        (32, 2560, 8960, 40, 64, 65536, 65536)
    assert cfg.block_pattern == ("rwkv",) and cfg.act == "relu2"
    assert cfg.rwkv and cfg.sparse_ffn and cfg.dtype == "bfloat16"
    assert cfg.periods == 32


@pytest.mark.parametrize("case", CASES)
def test_sparsify_model_packed_leaves_equal_reference(case):
    rcfg, _, _, rps, tps = _models(case)
    assert len(tps["blocks"]) == rcfg.periods
    for pk, bp in rps["blocks"].items():
        ref = bp["ffn_sparse"]
        assert ("gate_indices" in ref) == (rcfg.act == "swiglu")
        for p in range(rcfg.periods):
            got = tps["blocks"][p][pk]["ffn_sparse"]
            assert set(got) == set(ref)
            for k, v in ref.items():
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(v)[p], err_msg=k)
                assert got[k].dtype == (torch.int32 if "indices" in k
                                        else torch.float32)


def test_params_from_reference_round_trip():
    rcfg, _, rp, rps, _ = _models("qwen3_4b")
    tp = params_from_reference(jax.tree.map(np.asarray, rps), device=CPU)
    ref = jax.tree.map(np.asarray, rps)
    assert set(tp) == set(ref)
    for p in range(rcfg.periods):
        flat = jax.tree_util.tree_flatten_with_path(ref["blocks"])[0]
        for path, leaf in flat:
            node = tp["blocks"][p]
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), leaf[p])
    np.testing.assert_array_equal(tp["embed"].numpy(), ref["embed"])
    # bfloat16 leaves arrive exactly
    bf = params_from_reference({"embed": np.asarray(
        jnp.asarray(ref["embed"]).astype(jnp.bfloat16)), "blocks": {
        "p0": {"ln1": np.ones((2, 4), np.float32)}}}, device=CPU)
    assert bf["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        np.asarray(jnp.asarray(ref["embed"]).astype(jnp.bfloat16),
                   np.float32))
    assert len(bf["blocks"]) == 2


def test_init_params_shapes_and_seed():
    cfg = t_base.load_smoke("nemotron_4_340b")
    a = M.init_params(cfg, seed=3, device=CPU)
    b = M.init_params(cfg, seed=3, device=CPU)
    ref = RM.init_params(jax.random.PRNGKey(0), r_base.load_smoke(
        "nemotron_4_340b"))
    assert a["embed"].shape == ref["embed"].shape
    assert a["lm_head"].shape == ref["lm_head"].shape
    for pk, bp in ref["blocks"].items():
        shapes = jax.tree.map(lambda x: tuple(x.shape[1:]), bp)
        got = map_tree(lambda t: tuple(t.shape), a["blocks"][0][pk])
        assert got == shapes
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(map_tree(lambda t: t, a)),
        jax.tree.leaves(map_tree(lambda t: t, b))))


# ---------------------------------------------------------------------------
# logits against the reference (sparse FFNs at density 0.35)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_logits_match_reference(case):
    rcfg, tcfg, _, rps, tps = _models(case)
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]],
                    np.int32)
    rl, rc = RM.prefill(rps, rcfg, jnp.asarray(toks),
                        RM.init_cache(rcfg, 2, 12))
    tl, tc = M.prefill(tps, tcfg, torch.as_tensor(toks).long(),
                       M.init_cache(tcfg, 2, 12, device=CPU))
    assert _rel(tl, rl) <= TOL
    for p in range(rcfg.periods):
        assert _rel(tc[p]["p0"]["k"], np.asarray(rc["p0"]["k"])[p]) <= TOL
    nxt = np.array([[5], [7]], np.int32)
    pos = np.array([8, 8], np.int32)
    active = np.array([True, False])
    rd, rc2 = RM.decode_step(rps, rcfg, jnp.asarray(nxt), rc,
                             jnp.asarray(pos), active=jnp.asarray(active))
    td, tc2 = M.decode_step(tps, tcfg, torch.as_tensor(nxt).long(), tc,
                            torch.as_tensor(pos), active=torch.as_tensor(
                                active))
    assert _rel(td, rd) <= TOL
    # the inactive lane's cache passes through; the given cache is intact
    assert torch.equal(tc2[0]["p0"]["v"][1], tc[0]["p0"]["v"][1])
    assert not torch.equal(tc2[0]["p0"]["v"][0], tc[0]["p0"]["v"][0])
    assert _rel(tc2[0]["p0"]["v"], np.asarray(rc2["p0"]["v"])[0]) <= TOL


def test_forward_and_generate():
    rcfg, tcfg, _, rps, tps = _models("qwen_wide")
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    rl, _ = RM.forward(rps, jnp.asarray(toks), rcfg)
    tl, aux = M.forward(tps, torch.as_tensor(toks).long(), tcfg)
    assert tl.shape == rl.shape and _rel(tl, rl) <= TOL
    assert float(aux) == 0.0
    prefill = make_prefill_fn(tcfg)
    last = prefill(tps, torch.as_tensor(toks).long())
    assert torch.equal(last, tl[:, -1])
    last_c, _ = prefill(tps, torch.as_tensor(toks).long(),
                        M.init_cache(tcfg, 1, 8, device=CPU))
    assert _rel(last_c, last) <= TOL
    # generate: prefill's token, then decode steps at per-slot positions
    t = generate(tps, tcfg, torch.as_tensor(toks).long(), 4)
    assert t.shape == (1, 12) and torch.equal(t[:, :8], torch.as_tensor(
        toks).long())
    assert int(t[0, 8]) == int(tl[0, -1].argmax())
    sch = Scheduler(tcfg, tps, num_slots=1, max_len=12)
    got = sch.run([Request(0, toks[0], 4)])[0]
    assert got == t[0, 8:].tolist()


@pytest.mark.parametrize("case", ["qwen3_4b", "nemotron_4_340b"])
def test_sparse_equals_dense_at_full_density(case):
    """Packing and the balance fold are numerically a no-op at density 1.0
    (the tolerance tests/test_sparse_serving.py pins for the reference)."""
    _, tcfg = _cfgs(case)
    dense_cfg = dataclasses.replace(tcfg, sparse_ffn=False)
    params = M.init_params(tcfg, seed=0, device=CPU)
    params_s = sparsify_model(params, tcfg, density=1.0, num_shards=4)
    toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    ld, _ = M.forward(params, toks, dense_cfg)
    ls, _ = M.forward(params_s, toks, tcfg)
    np.testing.assert_allclose(ls.numpy(), ld.numpy(), rtol=5e-4,
                               atol=5e-4)
    cache = M.init_cache(tcfg, 2, 8, device=CPU)
    tok, pos = torch.tensor([[3], [7]]), torch.tensor([0, 0])
    ld, _ = M.decode_step(params, dense_cfg, tok, cache, pos)
    ls, _ = M.decode_step(params_s, tcfg, tok, cache, pos)
    np.testing.assert_allclose(ls.numpy(), ld.numpy(), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_array_equal(
        generate(params, dense_cfg, toks, 5).numpy(),
        generate(params_s, tcfg, toks, 5).numpy())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["qwen3_4b", "nemotron_4_340b"])
def test_scheduler_tokens_and_probe_match_reference(case):
    rcfg, tcfg, _, rps, tps = _models(case)
    rs = RScheduler(rcfg, rps, num_slots=2, max_len=16,
                    verify_artifacts=False)
    want = rs.run(_requests(rcfg, RRequest), probe_ffn=True)
    ts = Scheduler(tcfg, tps, num_slots=2, max_len=16)
    got = ts.run(_requests(tcfg, Request), probe_ffn=True)
    assert got == want
    assert (ts.stats.engine_steps, ts.stats.prefills, ts.stats.tokens,
            ts.stats.idle_lane_steps) == \
        (rs.stats.engine_steps, rs.stats.prefills, rs.stats.tokens,
         rs.stats.idle_lane_steps)
    assert ts.done_at == rs.done_at
    assert set(ts.ffn_probe) == set(rs.ffn_probe)
    for k, v in rs.ffn_probe.items():
        assert ts.ffn_probe[k] == v, k


def test_batch_composition_invariance():
    """A request decoded in a staggered batch with slot reuse equals the
    same request served alone on a scheduler of the same width."""
    _, tcfg, _, _, tps = _models("qwen_wide")
    reqs = _requests(tcfg, Request, n=3, max_new=4, stagger=2)
    got = Scheduler(tcfg, tps, num_slots=2, max_len=16).run(reqs)
    for r in reqs:
        solo = Scheduler(tcfg, tps, num_slots=2, max_len=16).run(
            [Request(r.rid, r.prompt, r.max_new)])
        assert solo[r.rid] == got[r.rid], r.rid


def test_slot_hygiene_and_queue_checks():
    _, tcfg, _, _, tps = _models("qwen3_4b")
    sch = Scheduler(tcfg, tps, num_slots=2, max_len=16)
    with pytest.raises(ValueError):
        sch.submit(Request(0, np.arange(1, 14), 4))       # 13 + 4 > 16
    with pytest.raises(ValueError):
        sch.submit(Request(0, np.arange(1, 4), 0))
    ones = map_tree(torch.ones_like, sch.cache)
    out = reset_slots(ones, torch.tensor([False, True]))
    assert bool((out[0]["p0"]["k"][0] == 1).all())
    assert bool((out[0]["p0"]["k"][1] == 0).all())
    assert sch.probe_ffn_stats() is None                   # nothing live


def test_unported_paths_raise():
    """The LM mesh stack is ported (ROADMAP A8b, ``tests/
    test_torch_dist_lm.py``): ``dist.act_sharding`` and ``launch.mesh``
    exist and the optimizer state has shardings; training, the optimizer,
    checkpoints and the data pipeline are (``tests/test_torch_train.py``,
    ``test_torch_ckpt.py``), and so are flash attention, MoE, Mamba, prefix
    and encoder-decoder models (``tests/test_torch_families.py``). The
    artifact verifier is ported (``tests/test_torch_analysis.py``): strict
    packing and the scheduler's admission gate, on by default, pass clean
    leaves."""
    _, tcfg = _cfgs("qwen3_4b")
    params = M.init_params(tcfg, seed=0, device=CPU)
    Scheduler(tcfg, params, verify_artifacts=True)       # no leaves yet
    sparse = sparsify_model(params, tcfg, strict=True)
    assert "ffn_sparse" in sparse["blocks"][0]["p0"]
    Scheduler(tcfg, sparse, num_slots=1, max_len=8)
    # both halves of the mesh port are in: vision (A8a) and LM (A8b)
    assert importlib.util.find_spec("repro_torch.dist") is not None
    assert importlib.util.find_spec("repro_torch.dist.act_sharding") \
        is not None
    assert importlib.util.find_spec("repro_torch.launch.mesh") is not None
    from types import SimpleNamespace
    from torch.distributed.tensor import Replicate
    from repro_torch.dist.partitioning import param_shardings
    from repro_torch.optim import adamw
    stub = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 2})
    p_sh = param_shardings(stub, M.abstract_params(tcfg))
    opt_sh = adamw.opt_shardings(stub, p_sh)
    assert opt_sh.mu is p_sh and opt_sh.nu is p_sh
    assert opt_sh.step.placements == (Replicate(), Replicate())
    for mod in ("train", "optim", "ckpt", "data"):
        assert importlib.util.find_spec(f"repro_torch.{mod}") is not None
    flash, _ = M.forward(params, torch.tensor([[1, 2, 3]]), tcfg,
                         flash_chunk=2)
    dense, _ = M.forward(params, torch.tensor([[1, 2, 3]]), tcfg)
    assert _rel(flash, dense) <= TOL


def test_launcher_serves_on_cpu(capsys):
    t_launch.main(["--arch", "nemotron_4_340b", "--smoke", "--sparse",
                   "--continuous", "--requests", "3", "--prompt-len", "6",
                   "--new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "activation-side skipped" in out
