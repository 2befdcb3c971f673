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
from repro_torch.dist import axis_names, dp_axes, partitioning, tp_axes
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

    DTensor weights (a mesh) take :func:`_attention_mesh`."""
    if isinstance(p["wq"], DTensor):
        return _attention_mesh(p, x, cfg, positions, mask, use_rope,
                               flash_chunk, kv=kv, return_kv=return_kv)
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


def _work_placements(mesh, batch: int, counts: Tuple[int, ...],
                     dim: int) -> tuple:
    """Placements of an activation whose work a rank does on its share:
    the batch (dim 0) over the data-parallel dims when they divide it, and
    tensor dim ``dim`` (heads or channels) over the longest prefix of the
    model dims whose product divides every one of ``counts`` (none when
    ``counts`` is empty); the rest replicated."""
    names = axis_names(mesh)
    out = [Replicate()] * mesh.ndim
    dp = [names.index(a) for a in dp_axes(mesh)]
    if batch % math.prod(mesh.size(i) for i in dp) == 0:
        for i in dp:
            out[i] = Shard(0)
    n = 1
    for a in tp_axes(mesh) if counts else ():
        i = names.index(a)
        n *= mesh.size(i)
        if any(c % n for c in counts):
            break
        out[i] = Shard(dim)
    return tuple(out)


def _head_placements(mesh, batch: int, cfg: ModelConfig) -> tuple:
    """Placements of a [B, S, heads * dh] projection (or [B, S, heads, dh]
    K/V) for attention by rank: the heads over the longest prefix of the
    model dims whose product divides both head counts, so a rank's query
    heads read its own KV heads (:func:`_work_placements`)."""
    return _work_placements(mesh, batch, (cfg.n_heads, cfg.n_kv_heads), 2)


def _weight_grads(place: tuple) -> tuple:
    """Gradient placements of a replicated weight read on local tensors
    split as ``place``: a partial sum over every dim that splits the
    work."""
    return tuple(Partial() if isinstance(pl, Shard) else pl for pl in place)


def _local_weight(t: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """The whole of weight ``t`` on this rank (FSDP shards gathered) for
    work split as ``place``; its gradient comes back as
    :func:`_weight_grads`."""
    return _replicated(t, mesh).to_local(grad_placements=_weight_grads(place))


def _to_placements(x: torch.Tensor, mesh, place: tuple) -> DTensor:
    """``x`` as a DTensor of ``place`` (a plain tensor is taken as the same
    on every rank)."""
    x = x if isinstance(x, DTensor) else _replicated(x, mesh)
    return x if tuple(x.placements) == place else x.redistribute(mesh, place)


def _local_state(state: torch.Tensor, mesh, place: tuple) -> torch.Tensor:
    """This rank's block of a decode-state tensor under ``place``."""
    return _to_placements(state, mesh, place).to_local()


def placed_like(new: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A new decode-state tensor in the placements of the state ``like``
    it replaces: a placed cache leaf stays in its ``cache_shardings``
    placements; one given as a plain tensor comes back whole."""
    if not isinstance(new, DTensor):
        return new
    if not isinstance(like, DTensor):
        return new.full_tensor()
    if tuple(new.placements) == tuple(like.placements):
        return new
    out = new.redistribute(like.device_mesh, like.placements)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * \
            local.element_size():
        # a block cut from a gathered buffer (the CPU process group's
        # all-to-all is an all-gather and a slice): a state leaf must not
        # pin the whole buffer
        out = DTensor.from_local(local.clone(), out.device_mesh,
                                 out.placements, run_check=False)
    return out


def _state_like(local: torch.Tensor, mesh, place: tuple,
                like: torch.Tensor) -> torch.Tensor:
    """:func:`placed_like` of this rank's block ``local``, laid out as
    ``place``."""
    return placed_like(DTensor.from_local(local, mesh, place,
                                          run_check=False), like)


def positions_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, S, ...] with its positions (dim 1) whole on every rank: a
    DTensor sharded over the sequence (the SP residual) gathered over the
    dims that split it; other tensors unchanged."""
    if not isinstance(x, DTensor) or not any(
            isinstance(pl, Shard) and pl.dim == 1 for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
        for pl in x.placements))


def _attention_mesh(p: Params, x, cfg: ModelConfig, positions, mask,
                    use_rope: bool, flash_chunk: Optional[int], *,
                    kv=None, return_kv: bool = False):
    """Attention with DTensor weights: the projections and ``wo`` as
    DTensor matmuls, and between them each rank attends over its own batch
    rows and heads (:func:`_head_placements`) on local tensors, the solo
    code on its share. DTensor's sharding rules for the attention's
    grouped einsums differ between torch releases; attention by head needs
    none. The qk-norm weights' gradients are partial sums over the dims
    that split the work. ``kv`` (cross-attention: DTensor or plain [B,
    S_kv, Hkv, dh], the encoder's or a placed cache's) is moved to the
    same placements; ``return_kv`` returns this layer's K/V as DTensors
    [B, S, Hkv, dh] in them. A mesh of one rank computes the solo values
    bit for bit. A sequence-sharded stream (SP) is gathered first, as
    Megatron's SP gathers before the QKV projections: DTensor mis-sizes
    the local view of a matmul whose weight shards over fewer model dims
    than the stream (the rules' head axes, e.g. PaliGemma's 8 heads on
    (8, 2))."""
    mesh = p["wq"].device_mesh
    x = positions_whole(x)
    B, S, _ = x.shape
    place = _head_placements(mesh, B, cfg)
    norms = {w: _local_weight(p[w], mesh, place)
             for w in ("q_norm", "k_norm") if w in p}
    rows = partitioning.local_slices(
        mesh, place, (B, S, cfg.n_heads * cfg.d_head))[0]
    if positions is not None and positions.shape[0] == B:
        positions = positions[rows]
    if mask is not None and mask.shape[0] == B:
        mask = mask[rows]
    if kv is None:
        q, k, v = ((x @ p[w]).redistribute(mesh, place).to_local()
                   for w in ("wq", "wk", "wv"))
        q, k, v = _heads(norms, q, k, v, cfg, positions, use_rope=use_rope)
    else:
        q = (x @ p["wq"]).redistribute(mesh, place).to_local()
        q = _heads(norms, q, q, q, cfg, positions, use_rope=use_rope)[0]
        k, v = (_to_placements(t, mesh, place).to_local() for t in kv)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if flash_chunk is not None and kv is None:
        out = _flash_sdpa(q, k, v, n_rep, window=cfg.window,
                          kv_chunk=flash_chunk)
    else:
        out = _sdpa(q, k, v, mask, n_rep)
    out = DTensor.from_local(out, mesh, place, run_check=False) @ p["wo"]
    if return_kv:
        return out, *(DTensor.from_local(t, mesh, place, run_check=False)
                      for t in (k, v))
    return out


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V [B, S_enc, Hkv, dh] of the encoder output (no
    RoPE). DTensor weights give DTensors in :func:`_head_placements`."""
    B, S, _ = enc_out.shape
    shape = (B, S, cfg.n_kv_heads, cfg.d_head)
    if not isinstance(p["wk"], DTensor):
        return tuple((enc_out @ p[w]).reshape(shape) for w in ("wk", "wv"))
    mesh = p["wk"].device_mesh
    place = _head_placements(mesh, B, cfg)
    enc_out = positions_whole(enc_out)
    out = []
    for w in ("wk", "wv"):
        local = (enc_out @ p[w]).redistribute(mesh, place).to_local()
        out.append(DTensor.from_local(
            local.reshape(*local.shape[:2], -1, cfg.d_head), mesh, place,
            run_check=False))
    return tuple(out)


def write_rows(cache: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """A copy of ``cache`` [B, S_max, ...] with rows [0, S) replaced by
    ``new`` [B, S, ...] (a prefill's K/V). A DTensor ``new`` (a mesh) is
    written on each rank's block in its placements, and the cache comes
    back in its own."""
    if not isinstance(new, DTensor):
        out = cache.clone()
        out[:, :new.shape[1]] = new.to(out.dtype)
        return out
    mesh, place = new.device_mesh, tuple(new.placements)
    local = _local_state(cache, mesh, place).clone()
    local[:, :new.shape[1]] = new.to_local().to(local.dtype)
    return _state_like(local, mesh, place, cache)


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache, barrier-free across the batch.

    x [B, 1, D]; cache_k/v [B, S_max, Hkv, dh]; pos int [B] (per-slot
    positions: lane b writes and attends at its own position). Returns
    (out [B,1,D], new_cache_k, new_cache_v); the given cache is not
    modified. DTensor weights take :func:`_attention_decode_mesh`.
    """
    if isinstance(p["wq"], DTensor):
        return _attention_decode_mesh(p, x, cfg, cache_k, cache_v, pos)
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    return _decode_attend(q, k, v, cache_k, cache_v, pos, cfg, p["wo"])


def _decode_attend(q, k, v, cache_k, cache_v, pos, cfg: ModelConfig, wo):
    """The decode step after the projections: lane b's K/V written at row
    pos[b] of copies of the caches, attention over its valid rows, then
    ``@ wo`` (None: the heads' output itself)."""
    B = q.shape[0]
    lanes = torch.arange(B, device=q.device)
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[lanes, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[lanes, pos] = v[:, 0].to(cache_v.dtype)
    ki = torch.arange(cache_k.shape[1], device=q.device)[None, :]
    valid = ki <= pos[:, None]                                # [B, S]
    if cfg.window is not None:
        valid &= ki > (pos[:, None] - cfg.window)
    out = _sdpa(q, cache_k, cache_v, valid[:, None, None],
                cfg.n_heads // cfg.n_kv_heads)
    return (out if wo is None else out @ wo), cache_k, cache_v


def _attention_decode_mesh(p: Params, x, cfg: ModelConfig, cache_k, cache_v,
                           pos):
    """:func:`attention_decode` with DTensor weights and a placed cache.
    Each rank takes its batch rows and heads (:func:`_head_placements`):
    the projections as DTensor matmuls, the caches moved to those
    placements (the baseline's sequence shards over ``model`` gathered, the
    rules' head shards kept), the row written and attended on local
    tensors as solo, the caches moved back to their own placements and the
    output through ``wo`` as a DTensor matmul. A mesh of one rank computes
    the solo values bit for bit."""
    mesh = p["wq"].device_mesh
    B = x.shape[0]
    place = _head_placements(mesh, B, cfg)
    norms = {w: _local_weight(p[w], mesh, place)
             for w in ("q_norm", "k_norm") if w in p}
    rows = partitioning.local_slices(
        mesh, place, (B, 1, cfg.n_heads * cfg.d_head))[0]
    pos = pos[rows]
    q, k, v = ((x @ p[w]).redistribute(mesh, place).to_local()
               for w in ("wq", "wk", "wv"))
    q, k, v = _heads(norms, q, k, v, cfg, pos[:, None])
    ck, cv = (_local_state(c, mesh, place) for c in (cache_k, cache_v))
    out, ck, cv = _decode_attend(q, k, v, ck, cv, pos, cfg, None)
    out = DTensor.from_local(out, mesh, place, run_check=False) @ p["wo"]
    return out, _state_like(ck, mesh, place, cache_k), \
        _state_like(cv, mesh, place, cache_v)


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
        # no redistribution where there is nothing to move: its backward
        # would reduce a partial gradient here, and the optimizer's
        # reduction (adamw.reduce_grads) once more
        return t if tuple(t.placements) == rep else t.redistribute(mesh, rep)
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


def _ssm_inputs(p: Params, u: torch.Tensor, cfg: ModelConfig, dtype,
                chan: slice = slice(None)):
    """The selective SSM's inputs from the conv output ``u`` (model dtype):
    (u fp32 after SiLU, delta, B, C, A). ``chan`` keeps the channels of u,
    delta and A that a rank scans (B and C read every channel)."""
    m = cfg.mamba
    dt_rank = max(cfg.d_model // 16, 1)
    u = F.silu(u).float()
    xp = (u.to(dtype) @ p["x_proj"]).float()
    dt, Bm, Cm = torch.split(xp, [dt_rank, m.d_state, m.d_state], dim=-1)
    delta = F.softplus(dt @ p["dt_proj"][:, chan].float()
                       + p["dt_bias"][chan])
    return u[..., chan], delta, Bm, Cm, -torch.exp(p["A_log"][chan])


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 64, return_state: bool = False):
    """Full-sequence Mamba. With ``return_state`` also returns the decode
    handoff ``(conv_state [B, d_conv-1, din], h [B, din, ds])``: the last
    d_conv-1 pre-conv inputs of the zero-padded stream (zeros ahead of them
    when L < d_conv-1) and the SSM state after the last token. DTensor
    weights take :func:`_mamba_mesh`."""
    if isinstance(p["in_proj"], DTensor):
        return _mamba_mesh(p, x, cfg, chunk, return_state)
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


def _mamba_local(p: Params, x, cfg: ModelConfig):
    """The mesh Mamba's set-up: (mesh, rows, chan, local weights, this
    rank's channels, local in_proj output u and z [B_l, L, din]; [B_l,
    din] for a decode step's [B, D] input).

    Each rank takes its batch rows (``rows``: the data dims) and a block
    of ``d_inner`` channels (``chan``: the longest prefix of the model dims
    dividing it, on dim 2 of [B, L, din]). ``x @ in_proj`` is a DTensor
    matmul whose output every rank of a batch block receives whole: the
    conv and ``x_proj`` read every channel (replicated work), the scan and
    the gate read this rank's, so the gradients of the local output and
    of the weights are partial sums over the channel dims."""
    mesh = p["in_proj"].device_mesh
    B = x.shape[0]
    din = cfg.mamba.expand * cfg.d_model
    rows = _work_placements(mesh, B, (), 2)
    chan = _work_placements(mesh, B, (din,), 2)
    act_grads = tuple(Partial() if isinstance(c, Shard) and
                      not isinstance(r, Shard) else r
                      for r, c in zip(rows, chan))
    xz = (x @ p["in_proj"]).redistribute(mesh, rows).to_local(
        grad_placements=act_grads)
    lp = {k: _local_weight(p[k], mesh, chan)
          for k in ("conv_w", "x_proj", "dt_proj", "dt_bias", "A_log", "D")}
    cs = partitioning.local_slices(mesh, chan, (B, 1, din))[2]
    u, z = xz.chunk(2, dim=-1)
    return mesh, rows, chan, lp, cs, u, z


def _mamba_mesh(p: Params, x, cfg: ModelConfig, chunk: int,
                return_state: bool):
    """:func:`mamba_block` with DTensor weights: the scan by batch rows and
    channel blocks on local tensors (:func:`_mamba_local`), the solo code
    on its share; the gated output back as a DTensor [B, L, din] sharded
    by channel into the DTensor matmul with ``out_proj``. The handoff's
    conv state is this batch block's (every channel), the SSM state its
    channel block's. A mesh of one rank computes the solo values bit for
    bit."""
    m = cfg.mamba
    L = x.shape[1]
    mesh, rows, chan, lp, cs, u, z = _mamba_local(p, x, cfg)
    upad = F.pad(u, (0, 0, m.d_conv - 1, 0))
    u = sum(upad[:, i:i + L] * lp["conv_w"][i] for i in range(m.d_conv))
    u, delta, Bm, Cm, A = _ssm_inputs(lp, u, cfg, x.dtype, cs)
    y, h_last = _ssm_scan_chunked(u, delta, Bm, Cm, A, chunk,
                                  return_state=True)
    y = y + u * lp["D"][cs]
    y = (y * F.silu(z[..., cs].float())).to(x.dtype)
    out = DTensor.from_local(y, mesh, chan, run_check=False) @ p["out_proj"]
    if return_state:
        h_place = _work_placements(mesh, x.shape[0], (m.expand * cfg.d_model,),
                                   1)
        return out, DTensor.from_local(upad[:, L:], mesh, rows,
                                       run_check=False), \
            DTensor.from_local(h_last, mesh, h_place, run_check=False)
    return out


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 conv_state: torch.Tensor, h: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step. x [B,1,D]; conv_state [B,d_conv-1,din]; h
    [B,din,ds] fp32 -> (out [B,1,D], new conv_state, new h); the given
    state is not modified. DTensor weights: the step by batch rows and
    channel blocks as :func:`_mamba_mesh`, the new state in the given
    state's placements."""
    if isinstance(p["in_proj"], DTensor):
        return _mamba_decode_mesh(p, x, cfg, conv_state, h)
    u, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)
    full = torch.cat([conv_state, u[:, None]], dim=1)        # [B,d_conv,din]
    y, h = _mamba_step(p, full, z, h, cfg, x.dtype)
    return (y @ p["out_proj"])[:, None], full[:, 1:], h


def _mamba_step(p: Params, full, z, h, cfg: ModelConfig, dtype,
                chan: slice = slice(None)):
    """The decode step after the in-projection: the conv over ``full``
    [B, d_conv, din], the SSM update of ``h`` and the gated output (model
    dtype), on the channels ``chan`` of the state and the output."""
    u = torch.einsum("bcd,cd->bd", full, p["conv_w"])
    u, delta, Bm, Cm, A = _ssm_inputs(p, u, cfg, dtype, chan)
    dA = torch.exp(delta[..., None] * A)                      # [B,din,ds]
    h = dA * h + delta[..., None] * Bm[:, None, :] * u[..., None]
    y = torch.einsum("bds,bs->bd", h, Cm) + u * p["D"][chan]
    return (y * F.silu(z[..., chan].float())).to(dtype), h


def _mamba_decode_mesh(p: Params, x, cfg: ModelConfig, conv_state, h):
    din = cfg.mamba.expand * cfg.d_model
    B = x.shape[0]
    # the solo step's ops on this rank's share: [B, D] rows in, the
    # output's channels on dim 1 of [B, din]
    mesh, rows, _, lp, cs, u, z = _mamba_local(p, x[:, 0], cfg)
    chan = _work_placements(mesh, B, (din,), 1)
    full = torch.cat([_local_state(conv_state, mesh, rows), u[:, None]],
                     dim=1)
    y, h_new = _mamba_step(lp, full, z, _local_state(h, mesh, chan), cfg,
                           x.dtype, cs)
    out = DTensor.from_local(y, mesh, chan, run_check=False) @ p["out_proj"]
    return out[:, None], _state_like(full[:, 1:], mesh, rows, conv_state), \
        _state_like(h_new, mesh, chan, h)


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
    state holds the last token and the WKV state after it. DTensor weights
    take :func:`_rwkv_time_mix_mesh`."""
    if isinstance(p["w_r"], DTensor):
        return _rwkv_time_mix_mesh(p, x, cfg, chunk, state)
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


def _shift_mesh(x: torch.Tensor, prev: Optional[torch.Tensor], mesh,
                rows: tuple):
    """The token shift on a mesh: (x, shifted) as DTensors of ``rows``
    (batch rows over the data dims, the sequence whole) and the last
    token [B, D] in them. The shift runs on local tensors; a shifted
    stream is the same on every rank of a batch block, so its gradient is
    too."""
    xr = _to_placements(x, mesh, rows)
    xl = xr.to_local()
    pl = None if prev is None else _local_state(prev, mesh, rows)
    shifted = DTensor.from_local(_token_shift(xl, pl), mesh, rows,
                                 run_check=False)
    return xr, shifted, xl[:, -1]


def _rwkv_time_mix_mesh(p: Params, x, cfg: ModelConfig, chunk: int,
                        state: Optional[Dict]):
    """:func:`rwkv_time_mix` with DTensor weights: the token mix and the
    five projections as DTensor ops, then the WKV by rank on local tensors
    over its batch rows (the data dims) and heads (the longest prefix of
    the model dims dividing ``n_heads``): the solo chunked recurrence on
    its share, with its block of ``u_bonus``, ``w_decay_base`` and the WKV
    state. The heads' output is gathered for ``ln_x`` (a norm over every
    head) and goes through the gate and ``w_o`` as DTensor ops. The bonus
    and base gradients are partial sums over the dims that split the work.
    A mesh of one rank computes the solo values bit for bit."""
    mesh = p["w_r"].device_mesh
    B, L, _ = x.shape
    H, N = cfg.n_heads, cfg.d_head
    rows = _work_placements(mesh, B, (), 2)
    heads = _work_placements(mesh, B, (H,), 2)
    xr, shifted, last = _shift_mesh(
        x, state["shift"] if state is not None else None, mesh, rows)

    def mix(mu):
        return xr * p[mu] + shifted * (1 - p[mu])

    def proj(mu, w):
        return (mix(mu) @ p[w]).redistribute(mesh, heads).to_local()

    hs = partitioning.local_slices(mesh, heads, (B, L, H))[2]
    cols = slice(hs.start * N, hs.stop * N)
    r, k, v = (proj(mu, w) for mu, w in
               (("mu_r", "w_r"), ("mu_k", "w_k"), ("mu_v", "w_v")))
    g = F.silu(mix("mu_w") @ p["w_g"])
    base = _local_weight(p["w_decay_base"], mesh, heads)[cols]
    wlog = -torch.exp(base + proj("mu_w", "w_w").float())
    u = _local_weight(p["u_bonus"], mesh, heads)[hs]
    s_place = _work_placements(mesh, B, (H,), 1)
    S0 = None if state is None else _local_state(state["wkv"], mesh,
                                                 s_place)
    shape = r.shape[:2] + (-1, N)            # [B_l, L, H_l, N]
    y, S = _rwkv_chunk(r.reshape(shape), k.reshape(shape), v.reshape(shape),
                       wlog.reshape(shape), u, S0, chunk)
    y = DTensor.from_local(y.reshape(r.shape).to(x.dtype), mesh, heads,
                           run_check=False).redistribute(mesh, rows)
    y = rmsnorm(y, p["ln_x"], cfg.norm_eps)
    out = (y * g.to(y.dtype)) @ p["w_o"]
    new_state = None
    if state is not None:
        new_state = {"shift": _state_like(last, mesh, rows, state["shift"]),
                     "wkv": _state_like(S, mesh, s_place, state["wkv"])}
    return out, new_state


def rwkv_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     state: Optional[Dict] = None,
                     sparse: Optional[Params] = None,
                     stats: Optional[list] = None
                     ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Squared-ReLU FFN of the token-shifted mix, dense or, with ``sparse``
    (this block's ``channel_mix_sparse`` leaves), through the BARISTA
    kernels with act ``relu2``: the naturally two-sided FFN of the
    attention-free blocks. ``stats`` collects the probe's counts. DTensor
    weights (dense): the shift on local tensors (:func:`_shift_mesh`), the
    FFN as DTensor ops."""
    prev = state["shift"] if state is not None else None
    if isinstance(p["w_in"], DTensor):
        mesh = p["w_in"].device_mesh
        rows = _work_placements(mesh, x.shape[0], (), 2)
        x, shifted, last = _shift_mesh(x, prev, mesh, rows)
        new_state = None if state is None else {
            "shift": _state_like(last, mesh, rows, prev)}
    else:
        shifted = _token_shift(x, prev)
        new_state = {"shift": x[:, -1]} if state is not None else None
    mixed = x * p["mu_in"] + shifted * (1 - p["mu_in"])
    if sparse is not None:
        if stats is not None:
            stats.append(sf.sparse_ffn_tile_stats(sparse, mixed, "relu2"))
        out = sf.sparse_ffn_apply(sparse, mixed, "relu2")
    else:
        h = torch.relu(mixed @ p["w_in"])
        out = (h * h) @ p["w_out"]
    return out, new_state


def init_rwkv_channel(gen: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype) -> Params:
    return {"mu_in": torch.full((cfg.d_model,), 0.5, dtype=dtype,
                                device=gen.device),
            "w_in": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "w_out": dense_init(gen, cfg.d_ff, cfg.d_model, dtype,
                                scale=1.0 / (2 * cfg.n_layers) ** 0.5)}
