"""Port parity, the remaining LM families: the online-softmax attention,
MoE, Mamba, the modality prefix and the encoder-decoder of ``repro_torch``
against the JAX reference on the same weights (carried across by
``convert.params_from_reference``) and the same numpy inputs from seed 0,
on the smoke configs in fp32; rel err <= 1e-5 unless a test states
otherwise. The sparse seamless paths reach the reference's Pallas FFN
kernels, which run with ``interpret=True`` here as in
``tests/test_torch_lm.py``."""
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
from repro.serve.engine import generate as r_generate
from repro.sparsity import expert_balance as reb
from repro.sparsity.sparse_ffn import sparsify_model as r_sparsify_model
from repro_torch.analysis import AnalysisError, verify_param_leaves
from repro_torch.configs import base as t_base
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as t_launch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import Request, Scheduler, generate, make_prefill_fn
from repro_torch.sparsity import expert_balance as teb
from repro_torch.sparsity.sparse_ffn import sparsify_model
from repro_torch.tree import map_tree

CPU = torch.device("cpu")
TOL = 1e-5
NEW = ["seamless_m4t_medium", "jamba_1_5_large_398b", "h2o_danube_3_4b",
       "yi_34b", "moonshot_v1_16b_a3b", "arctic_480b", "paligemma_3b"]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A reference (sub)tree of leaves as the port's tensors on the CPU."""
    return params_from_reference(_np(tree), device=CPU)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(ref cfg, port cfg, ref params, port params), the smoke config's
    reference weights from PRNGKey(0) carried across."""
    rcfg, tcfg = r_base.load_smoke(arch), t_base.load_smoke(arch)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, tcfg, rp, _port(rp)


@functools.lru_cache(maxsize=None)
def _sparse_seamless(density=0.35):
    rcfg, tcfg, rp, tp = _models("seamless_m4t_medium")
    rps = r_sparsify_model(rp, rcfg, density=density, num_shards=4)
    tps = sparsify_model(tp, tcfg, density=density, num_shards=4)
    return rcfg, tcfg, rps, tps


def _extras(cfg, B):
    """The stub frontend inputs of a smoke config: 4 encoder frames for an
    encoder-decoder, ``frontend_len`` prefix rows for a prefix model."""
    rng = np.random.default_rng(1)
    out = {}
    if cfg.encoder_layers:
        out["src_embeds"] = (0.02 * rng.normal(size=(B, 4, cfg.d_model))
                             ).astype(np.float32)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = (0.02 * rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW)
def test_init_params_and_carry_over_match_reference(arch):
    """The port's own params have the reference's tree and shapes per
    period; the carried-over ones equal the reference's leaves."""
    rcfg, tcfg, rp, tp = _models(arch)
    own = M.init_params(tcfg, seed=0, device=CPU)
    ref = _np(rp)
    assert set(own) == set(ref) == set(tp)
    for stack in ("blocks", "enc_blocks"):
        if stack not in ref:
            continue
        n = ref[stack]["p0"]["ln1"].shape[0]
        assert len(own[stack]) == len(tp[stack]) == n
        for pk, bp in ref[stack].items():
            shapes = jax.tree.map(lambda a: tuple(a.shape[1:]), bp)
            assert map_tree(lambda t: tuple(t.shape),
                            own[stack][0][pk]) == shapes
            for p in range(n):
                flat = jax.tree_util.tree_flatten_with_path(bp)[0]
                for path, leaf in flat:
                    node = tp[stack][p][pk]
                    for key in path:
                        node = node[key.key]
                    np.testing.assert_array_equal(node.numpy(), leaf[p])
    if "expert_perm" in ref:
        assert own["expert_perm"].dtype == tp["expert_perm"].dtype \
            == torch.int32
        np.testing.assert_array_equal(tp["expert_perm"].numpy(),
                                      ref["expert_perm"])
    for key in ("embed", "lm_head", "enc_norm"):
        if key in ref:
            assert tuple(own[key].shape) == ref[key].shape


# ---------------------------------------------------------------------------
# online-softmax attention
# ---------------------------------------------------------------------------
FLASH = {
    # name: (Sq, Sk, q_offset, H, Hkv, window, kv_chunk)
    "square_gqa": (40, 40, 0, 4, 2, None, 16),
    "offset_mha": (8, 40, 32, 4, 4, None, 16),
    "window_lt_chunk": (48, 48, 0, 4, 2, 10, 16),
    "window_gt_chunk_mha": (48, 48, 0, 4, 4, 24, 16),
    "offset_window": (16, 50, 34, 4, 2, 20, 16),
}


def _bf16_within_ulp(got, ref):
    """Each bf16 element at most one bf16 ulp from the other package's (the
    fp32 sums round once; their orders differ)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return bool(np.all(np.abs(got - ref) <= ulp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_sdpa_matches_reference(case, dtype):
    Sq, Sk, off, H, Hkv, window, chunk = FLASH[case]
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, s, h, 16)).astype(np.float32)
               for s, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    jd = jnp.dtype(dtype)
    ref = RL._flash_sdpa(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                         H // Hkv, window=window, kv_chunk=chunk,
                         q_offset=off)
    td = getattr(torch, dtype)
    got = L._flash_sdpa(*(_t(a).to(td) for a in (q, k, v)), H // Hkv,
                        window=window, kv_chunk=chunk, q_offset=off)
    assert got.dtype == td and tuple(got.shape) == ref.shape
    ref32 = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        assert _rel(got, ref32) <= TOL
        # and the dense masked path of the port on the same inputs
        mask = L.causal_mask(Sq, Sk, window, offset=off)
        dense = L._sdpa(_t(q), _t(k), _t(v), mask, H // Hkv)
        assert _rel(got, dense) <= TOL
    else:
        assert _bf16_within_ulp(got.float(), ref32)


def test_forward_and_prefill_with_flash_match_reference():
    """Danube's smoke config (window 32) at 48 tokens: the flash forward and
    prefill in 16-key chunks against the reference's, and against the
    port's dense masked forward."""
    rcfg, tcfg, rp, tp = _models("h2o_danube_3_4b")
    toks = np.random.default_rng(0).integers(1, rcfg.vocab, (2, 48)) \
        .astype(np.int32)
    rl, _ = RM.forward(rp, jnp.asarray(toks), rcfg, flash_chunk=16)
    tl, _ = M.forward(tp, _t(toks).long(), tcfg, flash_chunk=16)
    dl, _ = M.forward(tp, _t(toks).long(), tcfg)
    assert _rel(tl, rl) <= TOL and _rel(tl, dl) <= TOL
    rp_l, rc = RM.prefill(rp, rcfg, jnp.asarray(toks),
                          RM.init_cache(rcfg, 2, 50), flash_chunk=16)
    tp_l, tc = M.prefill(tp, tcfg, _t(toks).long(),
                         M.init_cache(tcfg, 2, 50, device=CPU),
                         flash_chunk=16)
    assert _rel(tp_l, rp_l) <= TOL
    assert _rel(tc[1]["p0"]["k"], np.asarray(rc["p0"]["k"])[1]) <= TOL
    last = make_prefill_fn(tcfg, flash_chunk=16)(tp, _t(toks).long())
    assert torch.equal(last, tl[:, -1])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
MOE = {
    # name: (arch, capacity factor or None for the config's, expert_perm)
    "moonshot": ("moonshot_v1_16b_a3b", None, False),
    "moonshot_perm": ("moonshot_v1_16b_a3b", None, True),
    "arctic_shared": ("arctic_480b", None, False),
    "arctic_shared_perm": ("arctic_480b", None, True),
    "moonshot_drops": ("moonshot_v1_16b_a3b", 0.5, True),
}


def _ref_route(p, x, cfg, perm):
    """The reference's routing, spelt out (``moe_ffn`` returns no ids)."""
    logits = jnp.asarray(x).reshape(-1, cfg.d_model).astype(jnp.float32) \
        @ p["router"]
    if perm is not None:
        logits = jnp.take(logits, perm, axis=1)
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)


@pytest.mark.parametrize("case", sorted(MOE))
def test_moe_ffn_matches_reference(case):
    arch, cf, with_perm = MOE[case]
    rcfg, tcfg = r_base.load_smoke(arch), t_base.load_smoke(arch)
    if cf is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    rp = RL.init_moe(jax.random.PRNGKey(0), rcfg, jnp.float32)
    tp = _port(rp)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, rcfg.d_model)).astype(np.float32)
    perm = rng.permutation(rcfg.moe.num_experts).astype(np.int32) \
        if with_perm else None
    rgates, rids = _ref_route(rp, x, rcfg, None if perm is None
                              else jnp.asarray(perm))
    _, tgates, tids = L.moe_route(tp, _t(x).reshape(-1, tcfg.d_model), tcfg,
                                  None if perm is None else _t(perm))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
    ro, raux = RL.moe_ffn(rp, jnp.asarray(x), rcfg,
                          None if perm is None else jnp.asarray(perm))
    to, taux = L.moe_ffn(tp, _t(x), tcfg, None if perm is None else _t(perm))
    assert _rel(to, ro) <= TOL
    assert abs(float(taux) - float(raux)) <= TOL * abs(float(raux))
    # the capacity and the assignments it drops
    T, K = x.shape[0] * x.shape[1], rcfg.moe.top_k
    cap = L.moe_capacity(T, tcfg)
    assert cap == int(T * K / rcfg.moe.num_experts
                      * rcfg.moe.capacity_factor) + 1
    counts = np.bincount(np.asarray(rids).reshape(-1),
                         minlength=rcfg.moe.num_experts)
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert (dropped > 0) == (case == "moonshot_drops")


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
def test_ssm_scan_chunked_matches_reference():
    """L = 37 in chunks of 16 (a padded last chunk), with the state."""
    rng = np.random.default_rng(0)
    B, Lq, din, ds = 2, 37, 24, 4
    u = rng.normal(size=(B, Lq, din)).astype(np.float32)
    delta = (0.1 * np.abs(rng.normal(size=(B, Lq, din)))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, Lq, ds)).astype(np.float32)
              for _ in range(2))
    A = -np.exp(rng.normal(size=(din, ds))).astype(np.float32)
    ry, rh = RL._ssm_scan_chunked(*(jnp.asarray(a) for a in
                                    (u, delta, Bm, Cm, A)), 16,
                                  return_state=True)
    ty, th = L._ssm_scan_chunked(*(_t(a) for a in (u, delta, Bm, Cm, A)),
                                 16, return_state=True)
    assert _rel(ty, ry) <= TOL and _rel(th, rh) <= TOL
    assert torch.equal(L._ssm_scan_chunked(*(_t(a) for a in
                                             (u, delta, Bm, Cm, A)), 16), ty)


@pytest.mark.parametrize("L0", [2, 37])
def test_mamba_block_and_decode_match_reference(L0):
    """``mamba_block(return_state=True)`` over L0 tokens, then 5
    ``mamba_decode`` steps, against the reference and against one block
    over all L0 + 5 tokens; L0 = 2 < d_conv - 1 = 3 hands off a conv state
    that starts with a zero row."""
    cfg_r = r_base.load_smoke("jamba_1_5_large_398b")
    cfg_t = t_base.load_smoke("jamba_1_5_large_398b")
    rp = RL.init_mamba(jax.random.PRNGKey(0), cfg_r, jnp.float32)
    tp = _port(rp)
    x = np.random.default_rng(0).normal(size=(2, L0 + 5, cfg_r.d_model)) \
        .astype(np.float32)
    ro, rconv, rh = RL.mamba_block(rp, jnp.asarray(x[:, :L0]), cfg_r,
                                   chunk=16, return_state=True)
    to, tconv, th = L.mamba_block(tp, _t(x[:, :L0]), cfg_t, chunk=16,
                                  return_state=True)
    assert _rel(to, ro) <= TOL and _rel(th, rh) <= TOL
    np.testing.assert_allclose(tconv.numpy(), np.asarray(rconv), rtol=TOL,
                               atol=0)
    if L0 < cfg_t.mamba.d_conv - 1:
        assert bool((tconv[:, 0] == 0).all())
    full = L.mamba_block(tp, _t(x), cfg_t, chunk=16)
    outs = []
    for t in range(L0, L0 + 5):
        ry, rconv, rh = RL.mamba_decode(rp, jnp.asarray(x[:, t:t + 1]),
                                        cfg_r, rconv, rh)
        ty, tconv, th = L.mamba_decode(tp, _t(x[:, t:t + 1]), cfg_t, tconv,
                                       th)
        assert _rel(ty, ry) <= TOL and _rel(th, rh) <= TOL
        outs.append(ty)
    assert _rel(torch.cat(outs, 1), full[:, L0:]) <= TOL


# ---------------------------------------------------------------------------
# whole models: forward, prefill, decode_step
# ---------------------------------------------------------------------------
def _cache_pair(rcfg, tcfg, rp, tp, B, max_len, extras):
    enc_len = extras["src_embeds"].shape[1] if "src_embeds" in extras else 0
    rc = RM.init_cache(rcfg, B, max_len, enc_len=enc_len)
    tc = M.init_cache(tcfg, B, max_len, enc_len=enc_len, device=CPU)
    if rcfg.encoder_layers:
        src = extras["src_embeds"]
        rc = RM.prefill_cache(rp, rcfg, rc, RM.encode(rp, jnp.asarray(src),
                                                      rcfg))
        tc = M.prefill_cache(tp, tcfg, tc, M.encode(tp, _t(src), tcfg))
    return rc, tc


def _check_cache(rcfg, rc, tc):
    for i, kind in enumerate(rcfg.block_pattern):
        keys = {"attn": ("k", "v"), "mamba": ("conv", "h")}[kind]
        if rcfg.encoder_layers:
            keys += ("cross_k", "cross_v")
        for key in keys:
            ref = np.asarray(rc[f"p{i}"][key])
            for p in range(rcfg.periods):
                assert _rel(tc[p][f"p{i}"][key], ref[p]) <= TOL, (i, key)


@pytest.mark.parametrize("arch", NEW)
def test_forward_prefill_decode_match_reference(arch):
    rcfg, tcfg, rp, tp = _models(arch)
    B = 2
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]],
                    np.int32)
    ex = _extras(rcfg, B)
    rl, raux = RM.forward(rp, jnp.asarray(toks), rcfg,
                          **{k: jnp.asarray(v) for k, v in ex.items()})
    tl, taux = M.forward(tp, _t(toks).long(), tcfg,
                         **{k: _t(v) for k, v in ex.items()})
    assert tl.shape == rl.shape == (B, 8, rcfg.padded_vocab)
    assert _rel(tl, rl) <= TOL
    assert abs(float(taux) - float(raux)) <= TOL * max(abs(float(raux)), 1.0)
    assert (float(taux) > 0) == (rcfg.moe is not None)
    if "prefix_embeds" in ex:           # not a prefix model's text alone
        nl, _ = M.forward(tp, _t(toks).long(), tcfg)
        assert _rel(nl, tl) > 1e-3

    rc, tc = _cache_pair(rcfg, tcfg, rp, tp, B, 12, ex)
    rpl, rc = RM.prefill(rp, rcfg, jnp.asarray(toks), rc)
    tpl, tc = M.prefill(tp, tcfg, _t(toks).long(), tc)
    assert _rel(tpl, rpl) <= TOL
    _check_cache(rcfg, rc, tc)
    if "prefix_embeds" not in ex:       # prefill == the forward's last row
        assert _rel(tpl, tl[:, -1]) <= TOL

    nxt, pos = np.array([[5], [7]], np.int32), np.array([8, 8], np.int32)
    active = np.array([True, False])
    rd, rc2 = RM.decode_step(rp, rcfg, jnp.asarray(nxt), rc,
                             jnp.asarray(pos), active=jnp.asarray(active))
    td, tc2 = M.decode_step(tp, tcfg, _t(nxt).long(), tc, _t(pos),
                            active=_t(active))
    assert _rel(td, rd) <= TOL
    _check_cache(rcfg, rc2, tc2)
    # the inactive lane's state passes through
    for key, a in tc2[0]["p0"].items():
        assert torch.equal(a[1], tc[0]["p0"][key][1]), key


# ---------------------------------------------------------------------------
# the sparse encoder-decoder
# ---------------------------------------------------------------------------
def test_sparsify_model_packs_the_encoder_like_reference():
    rcfg, _, rps, tps = _sparse_seamless()
    ref = _np(rps)
    for stack in ("blocks", "enc_blocks"):
        sp_ref = ref[stack]["p0"]["ffn_sparse"]
        assert "gate_indices" not in sp_ref              # relu: one stream
        for p in range(len(tps[stack])):
            got = tps[stack][p]["p0"]["ffn_sparse"]
            assert set(got) == set(sp_ref)
            for k, v in sp_ref.items():
                np.testing.assert_array_equal(got[k].numpy(), v[p],
                                              err_msg=f"{stack} {k}")
    # carried across, the reference's packed leaves are the port's
    carried = _port(rps)
    for p in range(rcfg.encoder_layers):
        for k, v in tps["enc_blocks"][p]["p0"]["ffn_sparse"].items():
            assert torch.equal(carried["enc_blocks"][p]["p0"]["ffn_sparse"][k],
                               v)


def test_strict_packing_and_admission_cover_the_encoder():
    _, tcfg, _, tp = _models("seamless_m4t_medium")
    sp = sparsify_model(tp, tcfg, num_shards=4, strict=True)
    assert not verify_param_leaves(sp, d_model=tcfg.d_model)
    leaf = dict(sp["enc_blocks"][1]["p0"]["ffn_sparse"])
    idx = leaf["in_indices"].clone()
    idx[0, 0] = idx.shape[0] * 1000                     # past K
    leaf["in_indices"] = idx
    enc = list(sp["enc_blocks"])
    enc[1] = {"p0": dict(enc[1]["p0"], ffn_sparse=leaf)}
    diags = verify_param_leaves(dict(sp, enc_blocks=enc),
                                d_model=tcfg.d_model)
    assert diags and all(d.path.startswith("enc_blocks/1/p0/ffn_sparse")
                         for d in diags)
    with pytest.raises(AnalysisError):
        Scheduler(dataclasses.replace(tcfg, encoder_layers=0),
                  dict(sp, enc_blocks=enc))


def test_sparse_seamless_encode_prefill_generate_match_reference():
    rcfg, tcfg, rps, tps = _sparse_seamless()
    ex = _extras(rcfg, 2)
    src = ex["src_embeds"]
    re_ = RM.encode(rps, jnp.asarray(src), rcfg)
    te = M.encode(tps, _t(src), tcfg)
    assert _rel(te, re_) <= TOL
    rc, tc = _cache_pair(rcfg, tcfg, rps, tps, 2, 12, ex)
    _check_cache(rcfg, rc, tc)
    toks = np.array([[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8]], np.int32)
    rl, _ = RM.forward(rps, jnp.asarray(toks), rcfg,
                       src_embeds=jnp.asarray(src))
    tl, _ = M.forward(tps, _t(toks).long(), tcfg, src_embeds=_t(src))
    assert _rel(tl, rl) <= TOL
    want = np.asarray(r_generate(rps, rcfg, jnp.asarray(toks), 6,
                                 src_embeds=jnp.asarray(src)))
    got = generate(tps, tcfg, _t(toks).long(), 6, src_embeds=_t(src))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 6]) == int(tl[0, -1].argmax())
    with pytest.raises(ValueError):
        generate(tps, tcfg, _t(toks).long(), 2)            # no src_embeds
    with pytest.raises(ValueError):
        generate(tps, tcfg, _t(toks).long(), 2, src_embeds=_t(src),
                 prefix_embeds=_t(src))
    with pytest.raises(ValueError):
        Scheduler(tcfg, tps)                               # decoder-only


# ---------------------------------------------------------------------------
# serving the MoE and hybrid families
# ---------------------------------------------------------------------------
def _requests(cfg, cls, n=3, prompt_len=6, max_new=5, stagger=1):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (n, prompt_len)).astype(np.int32)
    return [cls(rid=i, prompt=prompts[i], max_new=max_new,
                arrival=i * stagger) for i in range(n)]


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b",
                                  "moonshot_v1_16b_a3b"])
def test_scheduler_tokens_match_reference(arch):
    rcfg, tcfg, rp, tp = _models(arch)
    want = RScheduler(rcfg, rp, num_slots=2, max_len=16).run(
        _requests(rcfg, RRequest))
    sch = Scheduler(tcfg, tp, num_slots=2, max_len=16)
    got = sch.run(_requests(tcfg, Request))
    assert got == want
    assert sch.stats.tokens == 15 and sch.idle


# ---------------------------------------------------------------------------
# expert balance (tests/test_sparsity.py's cases, and the reference's
# arrays on the same load)
# ---------------------------------------------------------------------------
def test_expert_tracker_and_rebalance():
    tr, rtr = teb.ExpertLoadTracker(16), reb.ExpertLoadTracker(16)
    rng = np.random.default_rng(0)
    for _ in range(5):
        c = rng.lognormal(0, 1, 16)
        tr.update(c)
        rtr.update(c)
    np.testing.assert_array_equal(tr.load, rtr.load)
    perm = teb.rebalance(tr, num_shards=4)
    assert perm.dtype == np.int32
    assert sorted(perm.tolist()) == list(range(16))
    np.testing.assert_array_equal(perm, reb.rebalance(rtr, num_shards=4))
    before = tr.imbalance(4)
    after = teb.placement_imbalance(tr.load, perm, 4)
    assert after <= before + 1e-9
    assert (before, after) == (rtr.imbalance(4),
                               reb.placement_imbalance(rtr.load, perm, 4))
    assert teb.ExpertLoadTracker(4).imbalance(2) == 1.0
    np.testing.assert_array_equal(
        teb.rebalance(teb.ExpertLoadTracker(5), 2), np.arange(5))


def test_expert_counts():
    ids = torch.tensor([[0, 1], [1, 2], [1, 3]], dtype=torch.int32)
    c = teb.expert_counts(ids, 4)
    assert c.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), [1, 3, 1, 1])
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(reb.expert_counts(jnp.asarray(ids.numpy()), 4)))


def test_rebalance_rotates_with_step():
    tr = teb.ExpertLoadTracker(num_experts=16)
    tr.update(np.random.default_rng(1).lognormal(0, 1, 16))
    p0, p1 = teb.rebalance(tr, 4, step=0), teb.rebalance(tr, 4, step=1)
    assert not np.array_equal(p0, p1)
    rtr = reb.ExpertLoadTracker(num_experts=16, load=tr.load)
    np.testing.assert_array_equal(p1, reb.rebalance(rtr, 4, step=1))


def test_moe_forward_reads_the_rebalanced_permutation():
    """A rebalanced ``expert_perm`` reroutes the model exactly as the
    reference's does."""
    rcfg, tcfg, rp, tp = _models("moonshot_v1_16b_a3b")
    tr = teb.ExpertLoadTracker(rcfg.moe.num_experts)
    tr.update(np.random.default_rng(2).lognormal(0, 1, rcfg.moe.num_experts))
    perm = teb.rebalance(tr, 4)
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    rl, _ = RM.forward(dict(rp, expert_perm=jnp.asarray(perm)),
                       jnp.asarray(toks), rcfg)
    tl, _ = M.forward(dict(tp, expert_perm=_t(perm)), _t(toks).long(), tcfg)
    base, _ = M.forward(tp, _t(toks).long(), tcfg)
    assert _rel(tl, rl) <= TOL and _rel(tl, base) > 1e-4


def test_launcher_serves_seamless_on_cpu(capsys):
    t_launch.main(["--arch", "seamless_m4t_medium", "--smoke", "--sparse",
                   "--batch", "2", "--prompt-len", "6", "--new-tokens", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 10)" in out and "sparse=True" in out
