"""Port parity, RWKV6 serving: the chunked WKV recurrence, the RWKV6-3B
smoke model's ``forward`` / ``prefill`` / ``decode_step`` and its packed
``channel_mix_sparse`` leaves, and ``Scheduler`` greedy tokens and FFN
probe of ``repro_torch`` against the JAX reference on the same weights,
plus the lane hygiene of the WKV and token-shift state. Small sizes: the
2-layer ``rwkv6_3b`` smoke config (d_model 64, 4 heads of 16, d_ff 128)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve import Request as RRequest
from repro.serve import Scheduler as RScheduler
from repro.sparsity.sparse_ffn import sparse_ffn_apply as r_apply
from repro.sparsity.sparse_ffn import sparsify_model as r_sparsify_model
from repro_torch.configs import base as t_base
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as t_launch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import Request, Scheduler, reset_slots
from repro_torch.serve.engine import make_admit_fn
from repro_torch.sparsity.sparse_ffn import sparse_ffn_apply, sparsify_model
from repro_torch.tree import map_tree

CPU = torch.device("cpu")
ARCH = "rwkv6_3b"
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _models():
    """(ref cfg, port cfg, ref dense params, ref sparse params, port
    dense params, port sparse params): the port carries the dense weights
    across and packs them itself."""
    rcfg, tcfg = r_base.load_smoke(ARCH), t_base.load_smoke(ARCH)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    rps = r_sparsify_model(rp, rcfg, density=0.35, num_shards=4)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    tps = sparsify_model(tp, tcfg, density=0.35, num_shards=4)
    return rcfg, tcfg, rp, rps, tp, tps


def _requests(cfg, cls, n=3, prompt_len=6, max_new=5, stagger=1):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (n, prompt_len)).astype(np.int32)
    return [cls(rid=i, prompt=prompts[i], max_new=max_new,
                arrival=i * stagger) for i in range(n)]


@pytest.mark.parametrize("chunk", [1, 4, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_chunk_matches_reference(chunk, with_state):
    rng = np.random.default_rng(chunk)
    B, Lq, H, N = 2, 10, 3, 8
    r, k, v = (rng.normal(size=(B, Lq, H, N)).astype(np.float32)
               for _ in range(3))
    w = -np.exp(rng.normal(size=(B, Lq, H, N)) - 3).astype(np.float32)
    u = rng.normal(size=(H, N)).astype(np.float32) * 0.1
    S0 = rng.normal(size=(B, H, N, N)).astype(np.float32) \
        if with_state else None
    ry, rS = RL._rwkv_chunk(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                            None if S0 is None else jnp.asarray(S0), chunk)
    ty, tS = L._rwkv_chunk(*(torch.as_tensor(a) for a in (r, k, v, w, u)),
                           None if S0 is None else torch.as_tensor(S0),
                           chunk)
    assert ty.shape == (B, Lq, H, N) and ty.dtype == torch.float32
    assert tS.shape == (B, H, N, N) and tS.dtype == torch.float32
    assert _rel(ty, ry) <= TOL and _rel(tS, rS) <= TOL


def test_config_and_init_match_reference():
    rcfg, tcfg, rp, _, tp, _ = _models()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    mine = M.init_params(tcfg, seed=0, device=CPU)
    for key, ref in rp["blocks"]["p0"].items():
        shapes = jax.tree.map(lambda a: (tuple(a.shape[1:]), str(a.dtype)),
                              ref)
        got = map_tree(lambda t: (tuple(t.shape),
                                  str(t.dtype).split(".")[-1]),
                       mine["blocks"][0]["p0"][key])
        assert got == shapes, key
    # the fp32 leaves of a bf16 model stay fp32 across the carry-over
    bf = params_from_reference(jax.tree.map(
        np.asarray, RM.init_params(jax.random.PRNGKey(0), dataclasses.replace(
            rcfg, dtype="bfloat16"))), device=CPU)
    tm = bf["blocks"][1]["p0"]["time_mix"]
    assert tm["w_r"].dtype == torch.bfloat16
    assert tm["w_decay_base"].dtype == tm["u_bonus"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["blocks"][1]["p0"]["time_mix"]["u_bonus"].numpy(),
        np.asarray(rp["blocks"]["p0"]["time_mix"]["u_bonus"])[1])


def test_channel_mix_sparse_leaves_equal_reference():
    rcfg, _, _, rps, _, tps = _models()
    ref = rps["blocks"]["p0"]["channel_mix_sparse"]
    assert "ffn_sparse" not in rps["blocks"]["p0"]
    for p in range(rcfg.periods):
        got = tps["blocks"][p]["p0"]["channel_mix_sparse"]
        assert set(got) == set(ref) and "gate_indices" not in got
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v)[p],
                                          err_msg=k)


@pytest.mark.parametrize("sparse", [False, True])
def test_forward_prefill_decode_match_reference(sparse):
    rcfg, tcfg, rp, rps, tp, tps = _models()
    if not sparse:
        rcfg = dataclasses.replace(rcfg, sparse_ffn=False)
        tcfg = dataclasses.replace(tcfg, sparse_ffn=False)
        rps, tps = rp, tp
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]],
                    np.int32)
    rl, _ = RM.forward(rps, jnp.asarray(toks), rcfg, ssm_chunk=4)
    tl, _ = M.forward(tps, torch.as_tensor(toks).long(), tcfg, ssm_chunk=4)
    assert _rel(tl, rl) <= TOL
    rl, rc = RM.prefill(rps, rcfg, jnp.asarray(toks),
                        RM.init_cache(rcfg, 2, 12))
    tl, tc = M.prefill(tps, tcfg, torch.as_tensor(toks).long(),
                       M.init_cache(tcfg, 2, 12, device=CPU))
    assert _rel(tl, rl) <= TOL
    for p in range(rcfg.periods):
        for key in ("wkv", "shift_t", "shift_c"):
            assert _rel(tc[p]["p0"][key],
                        np.asarray(rc["p0"][key])[p]) <= TOL, key
    assert tc[0]["p0"]["wkv"].dtype == torch.float32
    nxt, pos = np.array([[5], [7]], np.int32), np.array([8, 8], np.int32)
    active = np.array([True, False])
    rd, rc2 = RM.decode_step(rps, rcfg, jnp.asarray(nxt), rc,
                             jnp.asarray(pos), active=jnp.asarray(active))
    td, tc2 = M.decode_step(tps, tcfg, torch.as_tensor(nxt).long(), tc,
                            torch.as_tensor(pos),
                            active=torch.as_tensor(active))
    assert _rel(td, rd) <= TOL
    # the inactive lane's state passes through; the given cache is intact
    assert torch.equal(tc2[0]["p0"]["wkv"][1], tc[0]["p0"]["wkv"][1])
    assert not torch.equal(tc2[0]["p0"]["wkv"][0], tc[0]["p0"]["wkv"][0])
    assert _rel(tc2[1]["p0"]["wkv"], np.asarray(rc2["p0"]["wkv"])[1]) <= TOL


def test_channel_mix_compact_schedule_matches_reference():
    """The channel-mix FFN through the work-list schedule (single-stream
    relu2 epilogue) against the reference's XLA executor and against the
    port's dense grid."""
    rcfg, _, _, rps, _, tps = _models()
    sp = tps["blocks"][0]["p0"]["channel_mix_sparse"]
    r_sp = {k: jnp.asarray(np.asarray(v)[0])
            for k, v in rps["blocks"]["p0"]["channel_mix_sparse"].items()}
    x = np.random.default_rng(1).normal(size=(2, 5, rcfg.d_model)) \
        .astype(np.float32)
    want = r_apply(r_sp, jnp.asarray(x), "relu2", schedule="compact",
                   executor="xla")
    got = sparse_ffn_apply(sp, torch.as_tensor(x), "relu2",
                           schedule="compact")
    assert _rel(got, want) <= TOL
    assert _rel(got, sparse_ffn_apply(sp, torch.as_tensor(x),
                                      "relu2")) <= TOL


def test_scheduler_tokens_and_probe_match_reference():
    rcfg, tcfg, _, rps, _, tps = _models()
    rs = RScheduler(rcfg, rps, num_slots=2, max_len=16,
                    verify_artifacts=False)
    want = rs.run(_requests(rcfg, RRequest), probe_ffn=True)
    ts = Scheduler(tcfg, tps, num_slots=2, max_len=16)
    got = ts.run(_requests(tcfg, Request), probe_ffn=True)
    assert got == want
    assert (ts.stats.engine_steps, ts.stats.prefills, ts.stats.tokens) == \
        (rs.stats.engine_steps, rs.stats.prefills, rs.stats.tokens)
    assert set(ts.ffn_probe) == set(rs.ffn_probe)
    for k, v in rs.ffn_probe.items():
        assert ts.ffn_probe[k] == v, k
    # relu2's zeros: the out projection skips sub-blocks the input has
    assert ts.ffn_probe["skipped_frac"] > 0


def test_no_stale_state_on_lane_reuse():
    """One slot, two requests back to back: the second gives what it gives
    alone, and admission and reset rewrite the WKV and shift lanes."""
    _, tcfg, _, _, _, tps = _models()
    reqs = _requests(tcfg, Request, n=2, prompt_len=6, max_new=4, stagger=0)
    got = Scheduler(tcfg, tps, num_slots=1, max_len=10).run(reqs)
    for r in reqs:
        alone = Scheduler(tcfg, tps, num_slots=1, max_len=10).run(
            [Request(r.rid, r.prompt, r.max_new)])
        assert alone[r.rid] == got[r.rid], r.rid
    dirty = map_tree(torch.ones_like, M.init_cache(tcfg, 2, 10,
                                                   device=CPU))
    prompt = torch.as_tensor(reqs[0].prompt[None]).long()
    _, cache = make_admit_fn(tcfg, 10)(tps, dirty, prompt, 0)
    _, lane = M.prefill(tps, tcfg, prompt, M.init_cache(tcfg, 1, 10,
                                                        device=CPU))
    for p in range(tcfg.periods):
        for key in ("wkv", "shift_t", "shift_c"):
            assert torch.equal(cache[p]["p0"][key][0], lane[p]["p0"][key][0])
            assert bool((cache[p]["p0"][key][1] == 1).all())
    out = reset_slots(dirty, torch.tensor([True, False]))
    for p in range(tcfg.periods):
        for key in ("wkv", "shift_t", "shift_c"):
            assert not out[p]["p0"][key][0].any()
            assert bool((out[p]["p0"][key][1] == 1).all())


def test_launcher_serves_rwkv_on_cpu(capsys):
    t_launch.main(["--arch", ARCH, "--smoke", "--sparse", "--continuous",
                   "--requests", "3", "--prompt-len", "6",
                   "--new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "rwkv6-smoke" in out and "12 tokens" in out
    assert "activation-side skipped" in out
