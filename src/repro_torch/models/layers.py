"""Layer library of the LM path (port of ``repro.models.layers``): attention
(GQA, RoPE, qk-norm, sliding window; dense masked or online-softmax
chunked), the FFN, dense or through the BARISTA sparse kernels, top-k MoE
with capacity, the Mamba selective SSM, and the RWKV6 time-mix and
channel-mix (the channel-mix's squared-ReLU FFN dense or sparse).

Conventions, as in the reference:
* params are plain dicts of tensors; every layer is ``fn(params, x, ...)``;
* compute in the config dtype, accumulate and normalize in fp32;
* decode paths take and return explicit state (the KV cache), and leave
  the state they were given unchanged.

Attention, MoE and the SSM scans have no kernel of their own in the
reference either (``jnp`` outside any Pallas kernel): they are plain
PyTorch here, with the reference's grouped einsums (no
``scaled_dot_product_attention``, whose numbers differ), and Python loops
over chunks where the reference scans.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
# a module import: dist.partitioning imports models.model, which imports
# this module
from repro_torch.dist import partitioning
from repro_torch.kernels.worklist_core import activate
from repro_torch.sparsity import sparse_ffn as sf

Params = Dict[str, Any]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float = 1.0) -> torch.Tensor:
    """[d_in, d_out] normal weights of std ``scale / sqrt(d_in)``, drawn in
    fp32 on ``gen``'s device and cast to ``dtype``."""
    std = scale / (d_in ** 0.5)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, S, H, dh]; positions [B, S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [dh/2]
    ang = positions[..., None].float() * freqs                # [B, S, dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> Params:
    d, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dtype,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=gen.device)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions, *,
         use_rope: bool = True):
    return _heads(p, x @ p["wq"], x @ p["wk"], x @ p["wv"], cfg, positions,
                  use_rope=use_rope)


def _heads(p: Params, q, k, v, cfg: ModelConfig, positions, *,
           use_rope: bool = True):
    """Projections [B, S, heads * dh] (all heads, or a rank's) -> [B, S,
    heads, dh] with qk-norm (``p["q_norm"]``, ``p["k_norm"]``) and RoPE."""
    B, S, _ = q.shape
    dh = cfg.d_head
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep: int) -> torch.Tensor:
    """q [B,Sq,H,dh]; k/v [B,Sk,Hkv,dh]; mask broadcastable [B,1,Sq,Sk].

    GQA through grouped einsums (q reshaped to [B,Sq,Hkv,n_rep,dh]) rather
    than repeating K/V; scores and softmax in fp32.
    """
    B, Sq, H, dh = q.shape
    if n_rep > 1:
        qg = q.reshape(B, Sq, H // n_rep, n_rep, dh)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                              k.float()) / (dh ** 0.5)
        if mask is not None:
            scores = torch.where(mask[:, :, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype), v)
        return out.reshape(B, Sq, H * dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / (dh ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H * dh)


def _flash_sdpa(q, k, v, n_rep: int, *, window: Optional[int] = None,
                kv_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax (flash-style) causal attention: only [B, Hkv, n_rep,
    Sq, kv_chunk] score tiles live at a time, with running (max, sum, out)
    accumulators; the S_q x S_k score matrix is never formed.

    q [B,Sq,H,dh]; k/v [B,Sk,Hkv,dh]; causal with an optional sliding
    window; ``q_offset`` is the absolute position of q[0] (prefill: Sq ==
    Sk, offset 0). Grouped q, no K/V repeat. The reference's numerics: q
    scaled once in its own dtype, scores from fp32 operands, p and the V
    tile in fp32, the finite ``NEG_INF`` mask (a fully masked early chunk
    of a windowed row adds terms that the first live chunk scales by
    exp(NEG_INF - m) = 0), the sum floored at 1e-30.
    """
    B, Sq, H, dh = q.shape
    Sk, G = k.shape[1], k.shape[2]
    R = H // G
    pad = (-Sk) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nch = (Sk + pad) // kv_chunk
    # the scale rounded to q's dtype on the host: the same product as a
    # 0-d tensor of that dtype, with no copy to the device (a capture
    # cannot take one)
    scale = torch.tensor(1.0 / (dh ** 0.5), dtype=q.dtype).item()
    qg = (q * scale).reshape(B, Sq, G, R, dh).float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    out = torch.zeros((B, G, R, Sq, dh), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, G, R, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((B, G, R, Sq), dtype=torch.float32, device=q.device)
    for ci in range(nch):
        sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
        kc, vc = k[:, sl].float(), v[:, sl].float()
        kpos = ci * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc)
        valid = (kpos[None, :] <= q_pos[:, None]) & (kpos[None, :] < Sk)
        if window is not None:
            valid &= kpos[None, :] > q_pos[:, None] - window
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * alpha + p.sum(-1)
        out = out * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p,
                                                    vc)
        m = m_new
    out = out / torch.clamp_min(den[..., None], 1e-30)
    # [B,G,R,Sq,dh] -> [B,Sq,G*R*dh], head order (g, r) as in q
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * dh).to(q.dtype)


def causal_mask(Sq: int, Sk: int, window: Optional[int] = None,
                offset: int = 0, device=None) -> torch.Tensor:
    """[1, 1, Sq, Sk]; query i attends to keys <= i+offset (within window)."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m[None, None]


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor],
              mask: Optional[torch.Tensor],
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              use_rope: bool = True, flash_chunk: Optional[int] = None,
              return_kv: bool = False):
    """Full-sequence attention (prefill, encoder, cross-attention).

    ``kv`` overrides keys/values (cross-attention reads the encoder's;
    ``positions=None`` with ``use_rope=False``). ``flash_chunk`` switches
    causal self-attention to the online-softmax path in ``flash_chunk``-key
    tiles (``mask`` is then not read). ``return_kv`` also returns the
    (RoPE'd) K/V, so a cache-writing prefill fills the decode cache in the
    same pass.

    DTensor weights (a mesh) take :func:`_attention_mesh` (self-attention
    without ``kv`` or ``return_kv``: the training forward)."""
    if isinstance(p["wq"], DTensor):
        if kv is not None or return_kv:
            raise NotImplementedError("sharded cross-attention and cache "
                                      "writes: only self-attention runs "
                                      "on a mesh")
        return _attention_mesh(p, x, cfg, positions, mask, use_rope,
                               flash_chunk)
    q, k, v = _qkv(p, x, cfg, positions, use_rope=use_rope)
    if kv is not None:
        k, v = kv
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if flash_chunk is not None and kv is None:
        out = _flash_sdpa(q, k, v, n_rep, window=cfg.window,
                          kv_chunk=flash_chunk)
    else:
        out = _sdpa(q, k, v, mask, n_rep)
    out = out @ p["wo"]
    if return_kv:
        return out, k, v
    return out


def _head_placements(mesh, batch: int, cfg: ModelConfig) -> tuple:
    """Placements of a [B, S, heads * dh] projection for attention by
    rank: the batch over the data-parallel dims (when they divide it), the
    heads over the longest prefix of the model dims whose product divides
    both head counts (so a rank's query heads read its own KV heads), the
    rest replicated."""
    names = partitioning.axis_names(mesh)
    out = [Replicate()] * mesh.ndim
    dp = [names.index(a) for a in partitioning.dp_axes(mesh)]
    if batch % math.prod(mesh.size(i) for i in dp) == 0:
        for i in dp:
            out[i] = Shard(0)
    n = 1
    for a in partitioning.tp_axes(mesh):
        i = names.index(a)
        n *= mesh.size(i)
        if cfg.n_heads % n or cfg.n_kv_heads % n:
            break
        out[i] = Shard(2)
    return tuple(out)


def _attention_mesh(p: Params, x, cfg: ModelConfig, positions, mask,
                    use_rope: bool, flash_chunk: Optional[int]):
    """Self-attention with DTensor weights: the projections and ``wo`` as
    DTensor matmuls, and between them each rank attends over its own batch
    rows and heads (:func:`_head_placements`) on local tensors, the solo
    code on its share. DTensor's sharding rules for the attention's
    grouped einsums differ between torch releases; attention by head needs
    none. The qk-norm weights' gradients are partial sums over the dims
    that split the work. A mesh of one rank computes the solo values bit
    for bit."""
    mesh = p["wq"].device_mesh
    B, S, _ = x.shape
    place = _head_placements(mesh, B, cfg)
    rep = (Replicate(),) * mesh.ndim
    split = tuple(Partial() if isinstance(pl, Shard) else pl
                  for pl in place)
    q, k, v = ((x @ p[w]).redistribute(mesh, place).to_local()
               for w in ("wq", "wk", "wv"))
    norms = {w: p[w].redistribute(mesh, rep).to_local(grad_placements=split)
             for w in ("q_norm", "k_norm") if w in p}
    shape = (B, S, cfg.n_heads * cfg.d_head)
    rows = partitioning.local_slices(mesh, place, shape)[0]
    if positions is not None and positions.shape[0] == B:
        positions = positions[rows]
    if mask is not None and mask.shape[0] == B:
        mask = mask[rows]
    q, k, v = _heads(norms, q, k, v, cfg, positions, use_rope=use_rope)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if flash_chunk is not None:
        out = _flash_sdpa(q, k, v, n_rep, window=cfg.window,
                          kv_chunk=flash_chunk)
    else:
        out = _sdpa(q, k, v, mask, n_rep)
    out = DTensor.from_local(out, mesh, place, run_check=False)
    return out @ p["wo"]


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache, barrier-free across the batch.

    x [B, 1, D]; cache_k/v [B, S_max, Hkv, dh]; pos int [B] (per-slot
    positions: lane b writes and attends at its own position). Returns
    (out [B,1,D], new_cache_k, new_cache_v); the given cache is not
    modified.
    """
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    lanes = torch.arange(B, device=x.device)
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[lanes, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[lanes, pos] = v[:, 0].to(cache_v.dtype)
    ki = torch.arange(cache_k.shape[1], device=x.device)[None, :]
    valid = ki <= pos[:, None]                                # [B, S]
    if cfg.window is not None:
        valid &= ki > (pos[:, None] - cfg.window)
    out = _sdpa(q, cache_k, cache_v, valid[:, None, None],
                cfg.n_heads // cfg.n_kv_heads)
    return out @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def init_ffn(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_in": dense_init(gen, d, f, dtype),
         "w_out": dense_init(gen, f, d, dtype,
                             scale=1.0 / (2 * cfg.n_layers) ** 0.5)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d, f, dtype)
    return p


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
        act: Optional[str] = None, sparse: Optional[Params] = None,
        stats: Optional[list] = None) -> torch.Tensor:
    """Dense FFN, or the BARISTA two-sided sparse path when ``sparse``
    (this block's packed ``sparsify_model`` leaves) is given; the dense
    weights in ``p`` are then bypassed. ``stats`` collects the executed /
    skipped tile-MAC counts per block."""
    a = act or cfg.act
    if sparse is not None:
        if stats is not None:
            stats.append(sf.sparse_ffn_tile_stats(sparse, x, a))
        return sf.sparse_ffn_apply(sparse, x, a)
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    return activate(h, g, a) @ p["w_out"]


# ---------------------------------------------------------------------------
# MoE (sort-based dispatch into per-expert capacity buffers)
# ---------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """Router (fp32 [D, E]), expert banks ``w_in``/``w_gate`` [E, D, Fe] and
    ``w_out`` [E, Fe, D], and the ``shared`` dense FFN when the config has
    one (Arctic)."""
    mc = cfg.moe
    d, fe, E = cfg.d_model, mc.d_ff_expert, mc.num_experts
    std_in, std_out = 1 / d ** 0.5, 1 / fe ** 0.5 / (2 * cfg.n_layers) ** 0.5

    def e_init(shape, std):
        return (torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32) * std).to(dtype)

    p = {"router": dense_init(gen, d, E, torch.float32),
         "w_in": e_init((E, d, fe), std_in),
         "w_out": e_init((E, fe, d), std_out)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = e_init((E, d, fe), std_in)
    if mc.shared_dense_ff:
        p["shared"] = init_ffn(gen, cfg, dtype, d_ff=mc.shared_dense_ff)
    return p


def moe_route(p: Params, xt: torch.Tensor, cfg: ModelConfig,
              expert_perm: Optional[torch.Tensor] = None):
    """Router of :func:`moe_ffn` on tokens ``xt [T, D]``: fp32 logits
    (columns read through ``expert_perm`` when given), softmax, top-k with
    the gates renormalised. Returns (probs [T, E], gates [T, K], expert ids
    [T, K])."""
    logits = xt.float() @ p["router"]
    if expert_perm is not None:
        logits = logits.index_select(1, expert_perm.long())
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), ids


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``int(T * K / E * capacity_factor) + 1``."""
    mc = cfg.moe
    return int(tokens * mc.top_k / mc.num_experts * mc.capacity_factor) + 1


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
            expert_perm: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity -> (out [B, S, D], Switch aux loss).

    Assignments are taken token-major ((t, k) order); each expert keeps its
    first ``moe_capacity`` (a stable sort gives each assignment its rank
    within its expert) and drops the rest. ``expert_perm`` (int [E]) is the
    BARISTA greedy-balance slot permutation (``sparsity.expert_balance``).

    Deterministic on any device: the dispatch writes each kept (expert,
    rank) slot once (dropped ones go to a spare slot that is cut off), and
    the combine sums each token's K gated expert outputs in the order
    k = 0 .. K-1, the reference's sequential scatter order, instead of an
    atomic scatter-add.

    With ``DTensor`` expert banks (expert parallelism on a mesh) see
    :func:`_moe_ffn_mesh`.
    """
    if isinstance(p["w_in"], DTensor):
        return _moe_ffn_mesh(p, x, cfg, expert_perm)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    out, aux = _moe_tokens(p, xt, xt, cfg, expert_perm, slice(None),
                           lambda eout: eout)
    if "shared" in p:
        out = out + ffn(p["shared"], x.reshape(B * S, D), cfg)
    return out.reshape(B, S, D), aux


def _moe_tokens(p: Params, xt: torch.Tensor, xd: torch.Tensor,
                cfg: ModelConfig, expert_perm, experts: slice,
                gather: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed part of :func:`moe_ffn` on all tokens: route ``xt`` [T,
    D], dispatch ``xd`` (the same values; a second handle so a mesh can
    give its gradient other placements), run the expert banks
    ``p["w_in"]`` (``w_gate``, ``w_out``) on the capacity buffers of
    ``experts`` (those the banks hold), ``gather`` the [E_local, cap, D]
    outputs into all E, combine -> (out [T, D], aux)."""
    mc = cfg.moe
    T, D = xt.shape
    E, K = mc.num_experts, mc.top_k
    probs, gates, ids = moe_route(p, xt, cfg, expert_perm)

    # aux load-balance loss (Switch); tokens per expert counted into a
    # fixed [E] (bincount reads the largest id back to the host to size its
    # output, which a CUDA graph cannot capture); integer counts, exact
    flat_e = ids.reshape(-1)                                   # [T*K]
    per_expert = torch.zeros((E,), dtype=torch.long, device=xt.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    ce = per_expert.float() / (T * K)
    aux = E * torch.sum(probs.mean(0) * ce)

    cap = moe_capacity(T, cfg)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(E, device=xt.device))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(T * K, device=xt.device) - seg_start[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, rank, cap)                  # cap: the spare

    # dispatch: [E, cap + 1, D], the spare slot cut off
    buf = torch.zeros((E, cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf[flat_e, slot] = xd[:, None].expand(T, K, D).reshape(T * K, D)
    buf = buf[experts, :cap]
    h = torch.bmm(buf, p["w_in"])
    g = torch.bmm(buf, p["w_gate"]) if "w_gate" in p else None
    eout = gather(torch.bmm(activate(h, g, cfg.act), p["w_out"]))

    # combine: gather back, scale by the gates, sum k = 0 .. K-1 per token
    gathered = eout[flat_e, torch.where(keep, rank, cap - 1)]
    contrib = torch.where(keep[:, None],
                          gathered * gates.reshape(-1, 1).to(xt.dtype), 0.0)
    contrib = contrib.to(xt.dtype).view(T, K, D)
    out = torch.zeros((T, D), dtype=xt.dtype, device=xt.device)
    for k in range(K):
        out = out + contrib[:, k]
    return out, aux


def _moe_ffn_mesh(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  expert_perm) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn` with expert banks sharded over the mesh dims that
    split their expert dim (expert parallelism).

    DTensor has no sharding rule for the dispatch's scatter and the
    combine's gather, so the routed part runs per rank on local tensors:
    every rank routes all ``B * S`` tokens (the capacity and the drops are
    those of the whole batch, as solo; the tokens are all-gathered over the
    data dims, the banks over any FSDP dim), runs its own experts' buffers,
    and the expert outputs are all-gathered over the expert-parallel dims
    before the combine. The routing, the dispatch and the combine are
    replicated work. Each local result is that of the solo path on the
    same values (a mesh of one rank is bitwise solo), and the gradients
    come back through DTensor: the output's all-gathered, the banks' for
    their own experts."""
    mesh = p["w_in"].device_mesh
    n = mesh.ndim
    rep = (Replicate(),) * n
    ep = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0
               else Replicate() for pl in p["w_in"].placements)
    B, S, D = x.shape
    xd = x if isinstance(x, DTensor) else DTensor.from_local(
        x, mesh, rep, run_check=False)
    banks = {k: v.redistribute(mesh, ep).to_local()
             for k, v in p.items() if k in ("w_in", "w_gate", "w_out")}
    lp = dict(banks, router=_replicated(p["router"], mesh).to_local())
    perm = None if expert_perm is None else \
        _replicated(expert_perm, mesh).to_local()
    experts = partitioning.local_slices(mesh, ep, p["w_in"].shape)[0]

    def gather(eout: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(eout, mesh, ep, run_check=False) \
            .redistribute(mesh, rep).to_local()

    # the routing reads every token on every rank (its gradient is
    # replicated); the dispatch feeds only this rank's experts, so its
    # gradient is a partial sum over the expert-parallel dims
    whole = xd.redistribute(mesh, rep)
    xt = whole.to_local().reshape(B * S, D)
    part = tuple(Partial() if isinstance(pl, Shard) else pl for pl in ep)
    xdl = whole.to_local(grad_placements=part).reshape(B * S, D)
    out, aux = _moe_tokens(lp, xt, xdl, cfg, perm, experts, gather)
    out = DTensor.from_local(out, mesh, rep, run_check=False)
    aux = DTensor.from_local(aux, mesh, rep, run_check=False)
    if "shared" in p:
        out = out + ffn(p["shared"], xd.reshape(B * S, D), cfg)
    # back to the stream's layout (a pending partial sum of the stream is
    # reduced, so the output is replicated there)
    back = tuple(Replicate() if isinstance(pl, Partial) else pl
                 for pl in xd.placements)
    return out.reshape(B, S, D).redistribute(mesh, back), aux


def _replicated(t: torch.Tensor, mesh) -> DTensor:
    """``t`` as a DTensor replicated over every dim of ``mesh`` (a plain
    tensor is taken as the same on every rank)."""
    rep = (Replicate(),) * mesh.ndim
    if isinstance(t, DTensor):
        return t.redistribute(mesh, rep)
    return DTensor.from_local(t, mesh, rep, run_check=False)


# ---------------------------------------------------------------------------
# Mamba (selective SSM; chunked scan, exact for diagonal A)
# ---------------------------------------------------------------------------
def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    m = cfg.mamba
    d = cfg.d_model
    din = m.expand * d
    dt_rank = max(d // 16, 1)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * din, dtype),
        "conv_w": (torch.randn((m.d_conv, din), generator=gen, device=dev,
                               dtype=torch.float32) * 0.1).to(dtype),
        "x_proj": dense_init(gen, din, dt_rank + 2 * m.d_state, dtype),
        "dt_proj": dense_init(gen, dt_rank, din, dtype),
        "dt_bias": torch.zeros((din,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, m.d_state + 1, dtype=torch.float32,
                                        device=dev).repeat(din, 1)),
        "D": torch.ones((din,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, din, d, dtype,
                               scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a, b) under
    ``(a_l, b_l) o (a_r, b_r) = (a_l a_r, b_l a_r + b_r)``: log-depth
    (Hillis-Steele), as the reference's ``associative_scan``."""
    off = 1
    while off < a.shape[1]:
        a, b = (torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1),
                torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                          1))
        off *= 2
    return a, b


def _ssm_scan_chunked(u, delta, Bm, Cm, A, chunk: int,
                      return_state: bool = False):
    """h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t ; y_t = C_t . h_t.

    u/delta [B, L, din]; Bm/Cm [B, L, ds]; A [din, ds] (negative), fp32.
    Chunked over L (the chunks in a loop, a log-depth scan inside each), so
    memory stays at B*chunk*din*ds. ``return_state`` also returns h at the
    last real token [B, din, ds]: padding has delta 0, so dA = 1 and
    dBu = 0, and the padded steps leave the state as it was.
    """
    Bsz, L, din = u.shape
    ds = Bm.shape[-1]
    pad = (-L) % chunk
    if pad:
        u, delta, Bm, Cm = (F.pad(a, (0, 0, 0, pad))
                            for a in (u, delta, Bm, Cm))
    h0 = torch.zeros((Bsz, din, ds), dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, u.shape[1], chunk):
        uc, dc, bc, cc = (a[:, c0:c0 + chunk] for a in (u, delta, Bm, Cm))
        dA = torch.exp(dc[..., None] * A)                     # [B,c,din,ds]
        dBu = dc[..., None] * bc[:, :, None, :] * uc[..., None]
        decays, incs = _linear_scan(dA, dBu)
        h = decays * h0[:, None] + incs
        ys.append(torch.einsum("bcds,bcs->bcd", h, cc))
        h0 = h[:, -1]
    y = torch.cat(ys, dim=1)[:, :L]
    return (y, h0) if return_state else y


def _ssm_inputs(p: Params, u: torch.Tensor, cfg: ModelConfig, dtype):
    """The selective SSM's inputs from the conv output ``u`` (model dtype):
    (u fp32 after SiLU, delta, B, C, A)."""
    m = cfg.mamba
    dt_rank = max(cfg.d_model // 16, 1)
    u = F.silu(u).float()
    xp = (u.to(dtype) @ p["x_proj"]).float()
    dt, Bm, Cm = torch.split(xp, [dt_rank, m.d_state, m.d_state], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"])
    return u, delta, Bm, Cm, -torch.exp(p["A_log"])


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 64, return_state: bool = False):
    """Full-sequence Mamba. With ``return_state`` also returns the decode
    handoff ``(conv_state [B, d_conv-1, din], h [B, din, ds])``: the last
    d_conv-1 pre-conv inputs of the zero-padded stream (zeros ahead of them
    when L < d_conv-1) and the SSM state after the last token."""
    m = cfg.mamba
    L = x.shape[1]
    u, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    # causal depthwise conv, in the model dtype
    upad = F.pad(u, (0, 0, m.d_conv - 1, 0))
    u = sum(upad[:, i:i + L] * p["conv_w"][i] for i in range(m.d_conv))
    u, delta, Bm, Cm, A = _ssm_inputs(p, u, cfg, x.dtype)
    y, h_last = _ssm_scan_chunked(u, delta, Bm, Cm, A, chunk,
                                  return_state=True)
    y = y + u * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        return out, upad[:, L:], h_last
    return out


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: torch.Tensor, h: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step. x [B,1,D]; conv_state [B,d_conv-1,din]; h
    [B,din,ds] fp32 -> (out [B,1,D], new conv_state, new h); the given
    state is not modified."""
    u, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)
    full = torch.cat([conv_state, u[:, None]], dim=1)        # [B,d_conv,din]
    u = torch.einsum("bcd,cd->bd", full, p["conv_w"])
    u, delta, Bm, Cm, A = _ssm_inputs(p, u, cfg, x.dtype)
    dA = torch.exp(delta[..., None] * A)                      # [B,din,ds]
    h = dA * h + delta[..., None] * Bm[:, None, :] * u[..., None]
    y = torch.einsum("bds,bs->bd", h, Cm) + u * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return (y @ p["out_proj"])[:, None], full[:, 1:], h


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay linear attention, chunked closed form
# ---------------------------------------------------------------------------
def init_rwkv(gen: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> Params:
    d = cfg.d_model
    H, N = cfg.n_heads, cfg.d_head
    dev = gen.device

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)

    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "w_r": dense_init(gen, d, H * N, dtype),
        "w_k": dense_init(gen, d, H * N, dtype),
        "w_v": dense_init(gen, d, H * N, dtype),
        "w_g": dense_init(gen, d, H * N, dtype),
        "w_w": dense_init(gen, d, H * N, dtype, scale=0.1),
        "w_decay_base": torch.full((H * N,), -6.0, dtype=torch.float32,
                                   device=dev),
        "u_bonus": torch.randn((H, N), generator=gen, device=dev,
                               dtype=torch.float32) * 0.1,
        "w_o": dense_init(gen, H * N, d, dtype,
                          scale=1.0 / (2 * cfg.n_layers) ** 0.5),
        "ln_x": torch.ones((H * N,), dtype=dtype, device=dev),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """shifted[t] = x[t-1]; ``prev`` supplies x[-1] for decode continuity
    (zeros without it)."""
    first = torch.zeros_like(x[:, :1]) if prev is None \
        else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_projections(p: Params, x: torch.Tensor, shifted: torch.Tensor,
                      cfg: ModelConfig):
    """r, k, v [B, L, H, N] and the silu gate in the model dtype; the
    log-decay ``w`` [B, L, H, N] (negative) in fp32."""
    H, N = cfg.n_heads, cfg.d_head
    B, L, _ = x.shape

    def mix(mu):
        return x * mu + shifted * (1 - mu)

    r = (mix(p["mu_r"]) @ p["w_r"]).reshape(B, L, H, N)
    k = (mix(p["mu_k"]) @ p["w_k"]).reshape(B, L, H, N)
    v = (mix(p["mu_v"]) @ p["w_v"]).reshape(B, L, H, N)
    g = F.silu(mix(p["mu_w"]) @ p["w_g"])
    # data-dependent decay in (0, 1): w = exp(-exp(base + proj))
    wlog = -torch.exp(p["w_decay_base"]
                      + (mix(p["mu_w"]) @ p["w_w"]).float())
    return r, k, v, g, wlog.reshape(B, L, H, N)


def _rwkv_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w_log: torch.Tensor, u: torch.Tensor,
                S0: Optional[torch.Tensor], chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV: S_t = diag(w_t) S_{t-1} + k_t v_t^T ; y_t = r_t (S_{t-1}
    + diag(u) k_t v_t^T). All [B, L, H, N] (w_log negative); S0 [B, H, N, N]
    fp32 or None (zeros). Each chunk is taken to fp32 in its step; returns
    (y [B, L, H, N] fp32, S [B, H, N, N] fp32)."""
    B, L, H, N = r.shape
    pad = (-L) % chunk
    if pad:
        r, k, v, w_log = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, w_log))
    nch = r.shape[1] // chunk
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) \
        if S0 is None else S0
    strict_lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                         device=r.device), -1)
    ys = []
    for c in range(nch):
        rc, kc, vc, wc = (a[:, c * chunk:(c + 1) * chunk].float()
                          for a in (r, k, v, w_log))          # [B,c,H,N]
        cum = torch.cumsum(wc, dim=1)          # log cumulative decay
        cum_prev = cum - wc                    # decay up to t-1
        r_t = rc * torch.exp(cum_prev)
        k_t = kc * torch.exp(-cum)
        # intra-chunk: y_i += sum_{j<i} (r~_i . k~_j) v_j
        A = torch.einsum("bihn,bjhn->bhij", r_t, k_t)
        A = torch.where(strict_lower[None, None], A, 0.0)
        y = torch.einsum("bhij,bjhn->bihn", A, vc)
        # u-bonus for the current token: y_i += (r_i . (u * k_i)) v_i
        y = y + torch.einsum("bihn,bihn->bih", rc * u[None, None],
                             kc)[..., None] * vc
        # cross-chunk: y_i += r~_i . S_in
        y = y + torch.einsum("bihn,bhnm->bihm", r_t, S)
        # S_out = diag(exp(cum_last)) S + sum_j exp(cum_last - cum_j) k_j v_j^T
        last = cum[:, -1][:, :, :, None]                       # [B,H,N,1]
        S = torch.exp(last) * S + torch.einsum(
            "bjhn,bjhm->bhnm", kc * torch.exp(cum[:, -1][:, None] - cum), vc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    return y, S


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 64, state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B, L, D] -> (out [B, L, D], new state). ``state`` (``shift``
    [B, D], ``wkv`` [B, H, N, N] fp32) continues a sequence; the returned
    state holds the last token and the WKV state after it."""
    B, L, D = x.shape
    H, N = cfg.n_heads, cfg.d_head
    prev = state["shift"] if state is not None else None
    shifted = _token_shift(x, prev)
    r, k, v, g, w = _rwkv_projections(p, x, shifted, cfg)
    S0 = state["wkv"] if state is not None else None
    y, S = _rwkv_chunk(r, k, v, w, p["u_bonus"], S0, chunk)
    y = rmsnorm(y.reshape(B, L, H * N).to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = (y * g.to(y.dtype)) @ p["w_o"]
    new_state = None
    if state is not None:
        new_state = {"shift": x[:, -1], "wkv": S}
    return out, new_state


def rwkv_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     state: Optional[Dict] = None,
                     sparse: Optional[Params] = None,
                     stats: Optional[list] = None
                     ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Squared-ReLU FFN of the token-shifted mix, dense or, with ``sparse``
    (this block's ``channel_mix_sparse`` leaves), through the BARISTA
    kernels with act ``relu2``: the naturally two-sided FFN of the
    attention-free blocks. ``stats`` collects the probe's counts."""
    prev = state["shift"] if state is not None else None
    shifted = _token_shift(x, prev)
    mixed = x * p["mu_in"] + shifted * (1 - p["mu_in"])
    if sparse is not None:
        if stats is not None:
            stats.append(sf.sparse_ffn_tile_stats(sparse, mixed, "relu2"))
        out = sf.sparse_ffn_apply(sparse, mixed, "relu2")
    else:
        h = torch.relu(mixed @ p["w_in"])
        out = (h * h) @ p["w_out"]
    new_state = {"shift": x[:, -1]} if state is not None else None
    return out, new_state


def init_rwkv_channel(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype) -> Params:
    return {"mu_in": torch.full((cfg.d_model,), 0.5, dtype=dtype,
                                device=gen.device),
            "w_in": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "w_out": dense_init(gen, cfg.d_ff, cfg.d_model, dtype,
                                scale=1.0 / (2 * cfg.n_layers) ** 0.5)}
