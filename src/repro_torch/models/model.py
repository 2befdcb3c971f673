"""Decoder LM of the dense-attention and RWKV6 families (port of
``repro.models.model``): params, the full-sequence forward, the decode
cache, single-pass prefill and the per-slot decode step.

Where the reference stacks block params over periods and scans them
(``lax.scan``), the port holds one entry per period in a list:
``params["blocks"][p]["p<i>"]`` is block i of period p's pattern, and the
decode cache is laid out the same way (``cache[p]["p<i>"]["k"]`` is
[B, S_max, Hkv, dh] for an attention block; an RWKV block keeps ``wkv``
[B, H, N, N] fp32 and the two token-shift rows ``shift_t``/``shift_c``
[B, D]). Encoder-decoder and prefix models, MoE and Mamba blocks are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]
Cache = List[Dict[str, Dict[str, torch.Tensor]]]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks are not ported yet")
    if cfg.encoder_layers:
        raise NotImplementedError("encoder-decoder models are not ported yet")
    if cfg.frontend is not None:
        raise NotImplementedError("modality-prefix models are not ported yet")
    for kind in cfg.block_pattern:
        if kind not in ("attn", "rwkv"):
            raise NotImplementedError(f"{kind!r} blocks are not ported yet "
                                      "(attention and RWKV only)")


def map_tree(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over nested dicts/lists of tensors of the
    same structure (the port's stand-in for ``jax.tree.map``)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(map_tree(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                dtype: torch.dtype) -> Params:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype,  # noqa: E731
                              device=gen.device)
    if kind == "rwkv":
        return {"ln1": ones(), "time_mix": L.init_rwkv(gen, cfg, dtype),
                "ln2": ones(),
                "channel_mix": L.init_rwkv_channel(gen, cfg, dtype)}
    return {"ln1": ones(), "attn": L.init_attention(gen, cfg, dtype),
            "ln2": ones(), "ffn": L.init_ffn(gen, cfg, dtype)}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Params:
    """Random params of ``cfg`` on ``device``, drawn from a generator
    seeded with ``seed`` on that device (the numbers differ from the
    reference's ``jax.random`` ones; ``convert.params_from_reference``
    carries those across)."""
    _check_supported(cfg)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    V = cfg.padded_vocab
    params: Params = {
        "embed": (torch.randn((V, cfg.d_model), generator=gen,
                              device=gen.device) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                 device=gen.device),
        "blocks": [{f"p{i}": _init_block(gen, cfg, kind, dtype)
                    for i, kind in enumerate(cfg.block_pattern)}
                   for _ in range(cfg.periods)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, V, dtype)
    return params


def _sparse_of(bp: Params, cfg: ModelConfig,
               key: str = "ffn_sparse") -> Optional[Params]:
    """Packed sparse-FFN leaves of this block when the BARISTA serving path
    is on: it needs both ``cfg.sparse_ffn`` and a ``sparsify_model`` pass
    over the params (dense params under a sparse config stay dense)."""
    if not cfg.sparse_ffn:
        return None
    return bp.get(key)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["lm_head"] if not cfg.tie_embeddings else params["embed"].t()
    return (x @ head.to(cfg.torch_dtype)).float()


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------
def _rwkv_block(bp: Params, entry: Optional[Dict[str, torch.Tensor]], x,
                cfg: ModelConfig, chunk: int, stats=None):
    """An RWKV block: time-mix, then the channel-mix (its sparse leaves
    when the BARISTA path is on). With a cache ``entry`` it continues the
    lane's state and returns the advanced entry."""
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    st = None if entry is None else {"shift": entry["shift_t"],
                                     "wkv": entry["wkv"]}
    y, st = L.rwkv_time_mix(bp["time_mix"], h, cfg, chunk=chunk, state=st)
    x = x + y
    h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    y2, st2 = L.rwkv_channel_mix(
        bp["channel_mix"], h2, cfg,
        state=None if entry is None else {"shift": entry["shift_c"]},
        sparse=_sparse_of(bp, cfg, "channel_mix_sparse"), stats=stats)
    new = None if entry is None else {"wkv": st["wkv"],
                                      "shift_t": st["shift"],
                                      "shift_c": st2["shift"]}
    return x + y2, new


def _block_fwd(bp: Params, x, cfg: ModelConfig, kind: str, *, positions,
               mask, ssm_chunk: Optional[int] = None):
    if kind == "rwkv":
        return _rwkv_block(bp, None, x, cfg, ssm_chunk or 64)[0]
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    x = x + L.attention(bp["attn"], h, cfg, positions=positions, mask=mask)
    h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + L.ffn(bp["ffn"], h2, cfg, sparse=_sparse_of(bp, cfg))


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefix_embeds=None, src_embeds=None,
            ssm_chunk: Optional[int] = None,
            flash_chunk: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits [B, S, V] fp32, moe_aux).
    ``ssm_chunk`` is the WKV chunk of RWKV blocks (default 64)."""
    _check_supported(cfg)
    if prefix_embeds is not None or src_embeds is not None:
        raise NotImplementedError("prefix and encoder inputs are not ported")
    if flash_chunk is not None:
        L._flash_sdpa()
    B, S = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(cfg.torch_dtype)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    mask = L.causal_mask(S, S, cfg.window, device=dev)
    for period in params["blocks"]:
        for i, kind in enumerate(cfg.block_pattern):
            x = _block_fwd(period[f"p{i}"], x, cfg, kind,
                           positions=positions, mask=mask,
                           ssm_chunk=ssm_chunk)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x), torch.zeros((), device=dev)


# ---------------------------------------------------------------------------
# decode (single-token step with explicit state)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Cache:
    """Zeroed decode state: per period, per pattern position, the K and V
    caches [batch, max_len, Hkv, dh] of an attention block, or an RWKV
    block's WKV state [batch, H, N, N] (fp32) and token-shift rows
    ``shift_t`` (time-mix) and ``shift_c`` (channel-mix) [batch, D]."""
    _check_supported(cfg)

    def zeros(*shape, dtype=cfg.torch_dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def entry(kind):
        if kind == "rwkv":
            return {"wkv": zeros(batch, cfg.n_heads, cfg.d_head, cfg.d_head,
                                 dtype=torch.float32),
                    "shift_t": zeros(batch, cfg.d_model),
                    "shift_c": zeros(batch, cfg.d_model)}
        shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    return [{f"p{i}": entry(kind) for i, kind in enumerate(cfg.block_pattern)}
            for _ in range(cfg.periods)]


def _block_decode(bp: Params, entry, x, cfg: ModelConfig, kind: str, pos,
                  stats=None):
    if kind == "rwkv":
        return _rwkv_block(bp, entry, x, cfg, 1, stats=stats)
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    y, k, v = L.attention_decode(bp["attn"], h, cfg, cache_k=entry["k"],
                                 cache_v=entry["v"], pos=pos)
    x = x + y
    h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    x = x + L.ffn(bp["ffn"], h2, cfg, sparse=_sparse_of(bp, cfg),
                  stats=stats)
    return x, {"k": k, "v": v}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, pos, *, active: Optional[torch.Tensor] = None,
                return_ffn_stats: bool = False):
    """token [B, 1] int; pos int scalar or [B] -> (logits [B,1,V], cache).

    ``pos`` may be a per-slot vector: lane b writes its KV at row pos[b]
    and attends with its own causal mask, so continuous-batching slots
    advance barrier-free. ``active`` [B] bool masks done/free slots: their
    cache lanes pass through unchanged. The given cache is not modified.

    ``return_ffn_stats`` also returns the sparse-FFN stats summed over all
    blocks (tile-MAC counts and work-list schedule counters, fp32
    scalars; zeros of the three tile-MAC keys when the params carry no
    sparse leaves).
    """
    B = token.shape[0]
    dev = token.device
    pos = torch.as_tensor(pos, device=dev).long().expand(B)
    x = params["embed"][token].to(cfg.torch_dtype)
    stats: Optional[list] = [] if return_ffn_stats else None
    new_cache = []
    for period, entries in zip(params["blocks"], cache):
        new = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}"
            x, new[key] = _block_decode(period[key], entries[key], x, cfg,
                                        kind, pos, stats=stats)
        new_cache.append(new)
    if active is not None:
        keep = active.to(dev).bool()
        new_cache = map_tree(
            lambda n, o: torch.where(
                keep.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
            new_cache, cache)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, cfg, x)
    if not return_ffn_stats:
        return logits, new_cache
    if stats:
        totals = {k: sum(s[k].cpu() for s in stats) for k in stats[0]}
    else:
        totals = {k: torch.tensor(0.0) for k in
                  ("executed", "weight_tile_macs", "dense_tile_macs")}
    return logits, new_cache, totals


# ---------------------------------------------------------------------------
# prefill (single-pass prompt -> cache)
# ---------------------------------------------------------------------------
def _block_prefill(bp: Params, entry, x, cfg: ModelConfig, kind: str, *,
                   positions, mask, ssm_chunk: Optional[int] = None):
    if kind == "rwkv":
        return _rwkv_block(bp, entry, x, cfg, ssm_chunk or 64)
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    y, k, v = L.attention(bp["attn"], h, cfg, positions=positions,
                          mask=mask, return_kv=True)
    S = k.shape[1]
    new_k, new_v = entry["k"].clone(), entry["v"].clone()
    new_k[:, :S] = k.to(new_k.dtype)
    new_v[:, :S] = v.to(new_v.dtype)
    x = x + y
    h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    x = x + L.ffn(bp["ffn"], h2, cfg, sparse=_sparse_of(bp, cfg))
    return x, {"k": new_k, "v": new_v}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, *, ssm_chunk: Optional[int] = None,
            flash_chunk: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """One forward pass over the prompt that fills the decode cache.

    tokens [B, S] -> (last_logits [B, V], cache with rows [0, S) written
    and RWKV states advanced past position S-1, in WKV chunks of
    ``ssm_chunk``, default 64). Lanes are expected to start from a zeroed
    cache (:func:`init_cache`).
    """
    if flash_chunk is not None:
        L._flash_sdpa()
    B, S = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(cfg.torch_dtype)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    mask = L.causal_mask(S, S, cfg.window, device=dev)
    new_cache = []
    for period, entries in zip(params["blocks"], cache):
        new = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}"
            x, new[key] = _block_prefill(period[key], entries[key], x, cfg,
                                         kind, positions=positions,
                                         mask=mask, ssm_chunk=ssm_chunk)
        new_cache.append(new)
    # project only the last position (the next-token logits serving needs)
    x = L.rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, x), new_cache
