"""Serving engine: single-pass prefill and barrier-free per-slot decode
(port of ``repro.serve.engine``).

``pos`` may be a per-slot vector: each batch lane writes and attends at
its own position, so continuous batching never makes a lane decode at
another lane's position. The slot lifecycle functions (``make_admit_fn``,
``reset_slots``) rebuild a reused lane from zeros before any read, so a
new request can never observe its predecessor's KV state.

The reference compiles these functions with ``jax.jit``. Here the decode
step is captured in a CUDA graph per batch width
(:class:`GraphedServeStep`, the counterpart of ``jitted_serve_step``),
which ``generate`` and the scheduler replay on the card; prefill,
admission and the FFN probe run eagerly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import graphs
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


@graphs.captured
def _step_body(params, cfg: ModelConfig, greedy: bool):
    """The captured decode step: (cache, packed [3, B] int64: token, pos,
    active) -> (next_token [B, 1], cache, logits [B, V]). The eager step on
    those inputs, its new cache copied into ``cache`` at the end (the
    graph's static buffers)."""
    def body(cache, packed):
        logits, new = M.decode_step(params, cfg, packed[0][:, None], cache,
                                    packed[1], active=packed[2].bool())
        M.map_tree(lambda dst, src: dst.copy_(src), cache, new)
        logits = logits[:, 0]
        return _pick(logits, greedy, None)[:, None], cache, logits
    return body


def _pack(token, pos, active) -> torch.Tensor:
    """token [B, 1], pos [B] (or a scalar) and active [B] (None: all live)
    as one int64 [3, B]: stacked on the card for tensors there, on the host
    for numpy arrays and host tensors (one copy to the card a step)."""
    B = token.shape[0]
    if isinstance(token, torch.Tensor) and token.device.type != "cpu":
        dev = token.device
        live = torch.ones((B,), dtype=torch.long, device=dev) \
            if active is None else torch.as_tensor(active, device=dev)
        return torch.stack([token.reshape(B).long(),
                            torch.as_tensor(pos, device=dev).long().expand(B),
                            live.long()])
    live = np.ones(B, np.int64) if active is None else np.asarray(active)
    return torch.from_numpy(np.stack([
        np.asarray(token).reshape(B), np.broadcast_to(np.asarray(pos), (B,)),
        live]).astype(np.int64))


class GraphedServeStep:
    """The decode step captured in a CUDA graph per batch width: the
    port's counterpart of the reference's ``jitted_serve_step``
    (``repro.serve.engine``). Called as the eager step is: (params, cache,
    token, pos[, active]) -> (next_token [B, 1], cache).

    One graph (:class:`repro_torch.graphs.CapturedGraph`) per key: the
    address, shape and type of every params leaf (what the capture bakes
    in: rebinding a leaf, as ``params["expert_perm"] = ...`` does, captures
    a new graph) and the cache's geometry (batch width, ``max_len``, the
    encoder length, types); the config and ``greedy`` are the object's.
    ``graphs`` holds them, each with the params leaves it reads, for as
    long as the caller holds this object.

    The cache is the graph's static buffer: the first call adopts the cache
    it is given and returns it, advanced in place; a call given that cache
    copies nothing, another cache of the same geometry is copied in first.
    ``token``, ``pos`` and ``active`` (None: every lane live) go in as one
    packed [3, B] copy. ``last_logits`` [B, V] fp32 are the last call's
    logits (the graph's buffer: the next call overwrites them). Greedy
    only: ``rng`` raises ``ValueError`` (sampling runs the eager
    :func:`make_serve_step`). On the CPU the body runs directly.
    """

    def __init__(self, cfg: ModelConfig, greedy: bool = True):
        self.cfg = cfg
        self.greedy = greedy
        self.graphs: dict = {}
        self.last_logits: Optional[torch.Tensor] = None

    def graph_for(self, params, cache) -> graphs.CapturedGraph:
        weights = graphs.leaves(params)
        key = (tuple((t.data_ptr(), t.shape, t.dtype) for t in weights),
               tuple((t.shape, t.dtype) for t in graphs.leaves(cache)))
        g = self.graphs.get(key)
        if g is None:
            g = graphs.CapturedGraph(
                _step_body(params, self.cfg, self.greedy), _device(params),
                f"{self.cfg.name} decode step (batch "
                f"{key[1][0][0][0]})", adopt=(0,), keep=weights)
            self.graphs[key] = g
        return g

    def __call__(self, params, cache, token, pos, active=None, rng=None):
        if rng is not None:
            raise ValueError("the graphed decode step is greedy; sampling "
                             "with rng runs the eager step "
                             "(make_serve_step, generate(compiled=False))")
        nxt, cache, self.last_logits = self.graph_for(params, cache)(
            cache, _pack(token, pos, active))
        return nxt.clone(), cache


def write_lane(cache, lane, slot: int):
    """Write a one-lane cache over lane ``slot`` of ``cache`` in place
    (every leaf's row ``slot``); returns ``cache``."""
    def write(big, ln):
        big[slot] = ln[0].to(big.dtype)
    M.map_tree(write, cache, lane)
    return cache


def prefill_lane(params, cfg: ModelConfig, max_len: int,
                 prompt: torch.Tensor, greedy: bool = True):
    """A zeroed one-lane cache with ``prompt`` [1, S] prefilled into it in
    one pass: (first_token [1, 1], lane), for :func:`write_lane`."""
    lane = M.init_cache(cfg, 1, max_len, device=_device(params))
    last, lane = M.prefill(params, cfg, prompt, lane)
    return _pick(last, greedy, None)[:, None], lane


def make_admit_fn(cfg: ModelConfig, max_len: int, greedy: bool = True):
    """Slot admission: (params, cache, prompt [1, S], slot) ->
    (first_token [1, 1], cache).

    Builds a zeroed one-lane cache, prefills the prompt into it in one
    pass, and writes it over lane ``slot`` of a copy of the shared cache
    whole: slot reuse cannot leak the previous occupant's state, and a late
    joiner's rows are position-exact.
    """
    if cfg.encoder_layers:
        raise ValueError("slot admission serves decoder-only models")

    def admit(params, cache, prompt, slot: int):
        first, lane = prefill_lane(params, cfg, max_len, prompt, greedy)
        return first, write_lane(M.map_tree(torch.clone, cache), lane, slot)
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
             prefix_embeds: Optional[torch.Tensor] = None,
             compiled: bool = True,
             step: Optional[GraphedServeStep] = None) -> torch.Tensor:
    """Batched generation: single-pass prefill of the whole prompt into the
    cache, then ``max_new - 1`` decode steps at per-slot positions; returns
    [B, S0 + max_new] tokens.

    ``compiled`` (the default, as the reference always jits) replays the
    captured decode step (:class:`GraphedServeStep`) and is greedy: ``rng``
    raises ``ValueError``. ``step`` is a :class:`GraphedServeStep` of
    ``cfg`` the caller holds to keep its graphs across calls (by default a
    new one, dropped on return; a held one copies the prefilled cache into
    its graph's buffers once). ``compiled=False`` runs the eager step
    (sampling with ``rng``, and the comparison runs). An
    encoder-decoder first encodes
    ``src_embeds`` [B, S_enc, D] and writes each decoder block's cross K/V
    into the cache. ``prefix_embeds`` is refused: the cache-writing
    prefill takes no prefix (the reference's ``generate`` takes one and
    drops it); a prefix model's prefix runs through
    :func:`repro_torch.models.model.forward`."""
    if prefix_embeds is not None:
        raise ValueError("generate's prefill takes no prefix_embeds; run a "
                         "prefix through forward(prefix_embeds=...)")
    if compiled and rng is not None:
        raise ValueError("generate(compiled=True) replays the greedy graphed "
                         "decode step; sample with compiled=False")
    if step is not None and (not compiled or step.cfg != cfg
                             or step.greedy != greedy):
        raise ValueError("generate(step=...) takes a GraphedServeStep of "
                         "the same cfg and greedy, with compiled=True")
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
    if step is None:
        step = GraphedServeStep(cfg, greedy) if compiled \
            else make_serve_step(cfg, greedy)
    last, cache = M.prefill(params, cfg, prompt, cache)
    tok = _pick(last, greedy, rng)[:, None].to(prompt.dtype)
    out = [prompt, tok]
    pos = torch.full((B,), S0, dtype=torch.long, device=prompt.device)
    for _ in range(max_new - 1):
        tok, cache = step(params, cache, tok, pos, None, rng)
        pos = pos + 1
        out.append(tok.to(prompt.dtype))
    return torch.cat(out, dim=1)
