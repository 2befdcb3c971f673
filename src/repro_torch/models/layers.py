"""Layer library of the LM path (port of ``repro.models.layers``): attention
(GQA, RoPE, qk-norm, sliding window), the FFN, dense or through the
BARISTA sparse kernels, and the RWKV6 time-mix and channel-mix (the
channel-mix's squared-ReLU FFN dense or sparse).

Conventions, as in the reference:
* params are plain dicts of tensors; every layer is ``fn(params, x, ...)``;
* compute in the config dtype, accumulate and normalize in fp32;
* decode paths take and return explicit state (the KV cache), and leave
  the state they were given unchanged.

Attention has no kernel of its own in the reference either: it is plain
PyTorch here, with the reference's grouped einsums (no
``scaled_dot_product_attention``); so is the chunked WKV recurrence, a
Python loop over chunks where the reference scans. The online-softmax
``_flash_sdpa``, MoE and Mamba are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
    B, S, _ = x.shape
    dh = cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, dh)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, dh)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, dh)
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


def _flash_sdpa(*args, **kwargs):
    """Online-softmax chunked attention: not ported yet."""
    raise NotImplementedError("_flash_sdpa is not ported yet")


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
              positions: torch.Tensor, mask: Optional[torch.Tensor],
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              use_rope: bool = True, flash_chunk: Optional[int] = None,
              return_kv: bool = False):
    """Full-sequence attention (prefill). ``kv`` overrides keys/values;
    ``return_kv`` also returns the (RoPE'd) K/V, so a cache-writing prefill
    fills the decode cache in the same pass."""
    if flash_chunk is not None:
        return _flash_sdpa()
    q, k, v = _qkv(p, x, cfg, positions, use_rope=use_rope)
    if kv is not None:
        k, v = kv
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads) @ p["wo"]
    if return_kv:
        return out, k, v
    return out


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
