"""Serving engine: single-pass prefill and barrier-free per-slot decode
(port of ``repro.serve.engine``).

``pos`` may be a per-slot vector: each batch lane writes and attends at
its own position, so continuous batching never makes a lane decode at
another lane's position. The slot lifecycle functions (``make_admit_fn``,
``reset_slots``) rebuild a reused lane from zeros before any read, so a
new request can never observe its predecessor's KV state.

The reference compiles these functions with ``jax.jit``; here they run
eagerly (a CUDA graph of the decode step is later work).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def _device(params) -> torch.device:
    return params["embed"].device


def make_prefill_fn(cfg: ModelConfig, ssm_chunk: Optional[int] = None,
                    flash_chunk: Optional[int] = None):
    """Prompt prefill: without ``cache`` the full-sequence forward's
    last-position logits (``extras``: ``prefix_embeds`` / ``src_embeds``);
    with ``cache`` one pass that also writes K/V rows [0, S) and the Mamba /
    RWKV handoff states into the decode cache -> ``(last_logits [B, V],
    cache)``. ``ssm_chunk`` and ``flash_chunk`` go to the model."""
    def prefill(params, tokens, cache=None, **extras):
        if cache is None:
            logits, _ = M.forward(params, tokens, cfg, ssm_chunk=ssm_chunk,
                                  flash_chunk=flash_chunk, **extras)
            return logits[:, -1]
        return M.prefill(params, cfg, tokens, cache, ssm_chunk=ssm_chunk,
                         flash_chunk=flash_chunk)
    return prefill


def _pick(logits: torch.Tensor, greedy: bool,
          rng: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy (first maximum) or a sample drawn with ``rng``."""
    if greedy or rng is None:
        return torch.argmax(logits, dim=-1)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=rng)[:, 0]


def make_serve_step(cfg: ModelConfig, greedy: bool = True):
    """One decode iteration: (params, cache, token, pos[, active, rng]) ->
    (next_token [B, 1], cache). ``active`` [B] bool masks done/free slots:
    their cache lanes pass through untouched while live lanes advance."""
    def serve_step(params, cache, token, pos, active=None, rng=None):
        logits, cache = M.decode_step(params, cfg, token, cache, pos,
                                      active=active)
        return _pick(logits[:, 0], greedy, rng)[:, None], cache
    return serve_step


def make_admit_fn(cfg: ModelConfig, max_len: int, greedy: bool = True):
    """Slot admission: (params, cache, prompt [1, S], slot) ->
    (first_token [1, 1], cache).

    Builds a zeroed one-lane cache, prefills the prompt into it in one
    pass, and writes it over lane ``slot`` of the shared cache whole:
    slot reuse cannot leak the previous occupant's state, and a late
    joiner's rows are position-exact.
    """
    if cfg.encoder_layers:
        raise ValueError("slot admission serves decoder-only models")

    def admit(params, cache, prompt, slot: int):
        lane = M.init_cache(cfg, 1, max_len, device=_device(params))
        last, lane = M.prefill(params, cfg, prompt, lane)

        def write(big, ln):
            big = big.clone()
            big[slot] = ln[0].to(big.dtype)
            return big

        return _pick(last, greedy, None)[:, None], M.map_tree(write, cache,
                                                              lane)
    return admit


def make_ffn_stats_fn(cfg: ModelConfig):
    """Read-only instrumented decode step: (params, cache, token, pos
    [, active]) -> the sparse-FFN stats summed over all blocks. The step's
    logits and cache are discarded, so the serving state is untouched."""
    def stats_step(params, cache, token, pos, active=None):
        return M.decode_step(params, cfg, token, cache, pos, active=active,
                             return_ffn_stats=True)[2]
    return stats_step


def reset_slots(cache, free_mask: torch.Tensor):
    """Zero the cache lanes where ``free_mask`` [B] is True."""
    def zero(a):
        keep = (~free_mask.to(a.device).bool()).reshape(
            (-1,) + (1,) * (a.ndim - 1))
        return a * keep.to(a.dtype)
    return M.map_tree(zero, cache)


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, max_new: int,
             *, greedy: bool = True, rng: Optional[torch.Generator] = None,
             src_embeds: Optional[torch.Tensor] = None,
             prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched generation: single-pass prefill of the whole prompt into the
    cache, then ``max_new - 1`` decode steps at per-slot positions; returns
    [B, S0 + max_new] tokens. An encoder-decoder first encodes
    ``src_embeds`` [B, S_enc, D] and writes each decoder block's cross K/V
    into the cache. ``prefix_embeds`` is refused: the cache-writing
    prefill takes no prefix (the reference's ``generate`` takes one and
    drops it); a prefix model's prefix runs through
    :func:`repro_torch.models.model.forward`."""
    if prefix_embeds is not None:
        raise ValueError("generate's prefill takes no prefix_embeds; run a "
                         "prefix through forward(prefix_embeds=...)")
    B, S0 = prompt.shape
    enc_len = src_embeds.shape[1] if src_embeds is not None else 0
    cache = M.init_cache(cfg, B, S0 + max_new, enc_len=enc_len,
                         device=prompt.device)
    if cfg.encoder_layers:
        if src_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: generate "
                             "needs src_embeds")
        cache = M.prefill_cache(params, cfg, cache,
                                M.encode(params, src_embeds, cfg))
    step = make_serve_step(cfg, greedy)
    last, cache = M.prefill(params, cfg, prompt, cache)
    tok = _pick(last, greedy, rng)[:, None].to(prompt.dtype)
    out = [prompt, tok]
    pos = torch.full((B,), S0, dtype=torch.long, device=prompt.device)
    for _ in range(max_new - 1):
        tok, cache = step(params, cache, tok, pos, None, rng)
        pos = pos + 1
        out.append(tok.to(prompt.dtype))
    return torch.cat(out, dim=1)
