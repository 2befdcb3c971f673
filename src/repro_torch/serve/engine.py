"""Serving engine: single-pass prefill and barrier-free per-slot decode
(port of ``repro.serve.engine``).

``pos`` may be a per-slot vector: each batch lane writes and attends at
its own position, so continuous batching never makes a lane decode at
another lane's position. The slot lifecycle functions (``make_admit_fn``,
``reset_slots``) rebuild a reused lane from zeros before any read, so a
new request can never observe its predecessor's KV state.

The reference compiles these functions with ``jax.jit``. Here each is
captured in a CUDA graph (:mod:`repro_torch.graphs`) and replayed on the
card: the decode step per batch width, greedy or sampled
(:class:`GraphedServeStep`, the counterpart of ``jitted_serve_step``), the
cache-writing prefill per prompt length and batch width
(:class:`GraphedPrefill`, ``jitted_prefill``), slot admission per prompt
length (:class:`GraphedAdmit`, ``jitted_admit``; the slot is a device
tensor, as the reference's is traced) and the FFN probe
(:class:`GraphedFfnStats`, ``jitted_ffn_stats``). ``generate`` and the
scheduler use them by default; ``compiled=False`` runs the eager
functions.

On a mesh (the reference's sharded serve step, which its dry run lowers
with ``jax.jit(in_shardings=...)``), :func:`make_prefill_fn` and
:func:`make_serve_step` take DTensor params
(``dist.partitioning.param_shardings``) and a decode cache placed by
``cache_shardings`` (:func:`init_cache_on`); the new cache keeps those
placements, and the greedy pick runs on each rank's rows with the vocab
gathered. :class:`GraphedServeStep` captures that step too. The
scheduler and ``generate`` stay one-device, as the reference's are.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import partitioning as part
from repro_torch.models import model as M
from repro_torch.tree import leaves, map_tree


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
            return M.positions_whole(logits)[:, -1]
        return M.prefill(params, cfg, tokens, cache, ssm_chunk=ssm_chunk,
                         flash_chunk=flash_chunk)
    return prefill


def _pick(logits: torch.Tensor, greedy: bool,
          rng: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy (first maximum) or a sample drawn with ``rng``.

    The sample is ``torch.multinomial(p, 1, generator=rng)`` written out as
    that function draws one sample (``argmax(p / q)``, ``q ~ Exp(1)`` from
    ``rng``): the same tokens and the same draws from ``rng``, without its
    host-side check of ``p``, which reads the device and so cannot be
    captured. DTensor logits (a mesh) are picked greedily on each rank's
    rows, the vocab gathered first."""
    if isinstance(logits, DTensor):
        if not (greedy or rng is None):
            raise ValueError("a mesh's serve step picks greedily only")
        return _argmax_mesh(logits)
    if greedy or rng is None:
        return torch.argmax(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    q = torch.empty_like(p).exponential_(1, generator=rng)
    return torch.argmax(p / q, dim=-1)


def _argmax_mesh(logits: DTensor) -> DTensor:
    """``argmax(logits, -1)`` of DTensor logits [B, V]: the vocab gathered
    over the dims that shard it, then each rank's rows on local tensors
    (the first maximum, as solo); the tokens in the rows' placements."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    place = tuple(pl if isinstance(pl, Shard) and pl.dim % logits.ndim
                  != last else Replicate() for pl in logits.placements)
    local = logits.redistribute(mesh, place).to_local()
    return DTensor.from_local(torch.argmax(local, dim=-1), mesh, place,
                              run_check=False)


def init_cache_on(mesh, cfg: ModelConfig, batch: int, max_len: int, *,
                  enc_len: int = 0, rules: Optional[part.Rules] = None,
                  device="cuda"):
    """A zeroed decode cache (:func:`repro_torch.models.model.init_cache`)
    placed on ``mesh`` by ``dist.partitioning.cache_shardings`` (``rules``:
    the head-sharded layout of ``--opt``): each rank allocates only its
    own block of each leaf. On the meta device it holds shapes only.
    Returns (cache, its ``NamedSharding`` tree)."""
    abs_cache = M.init_cache(cfg, batch, max_len, enc_len=enc_len,
                             device="meta")
    sh = part.cache_shardings(mesh, abs_cache, batch, rules=rules)
    return map_tree(lambda t, s: part.placed_zeros(s, t.shape, t.dtype,
                                                   device),
                    abs_cache, sh), sh


def make_serve_step(cfg: ModelConfig, greedy: bool = True):
    """One decode iteration: (params, cache, token, pos[, active, rng]) ->
    (next_token [B, 1], cache). ``active`` [B] bool masks done/free slots:
    their cache lanes pass through untouched while live lanes advance."""
    def serve_step(params, cache, token, pos, active=None, rng=None):
        logits, cache = M.decode_step(params, cfg, token, cache, pos,
                                      active=active)
        return _pick(logits[:, 0], greedy, rng)[:, None], cache
    return serve_step


def _copy_into(dst, src):
    """Copy every leaf of ``src`` into the same leaf of ``dst``; returns
    ``dst``."""
    map_tree(lambda d, s: d.copy_(s), dst, src)
    return dst


def _params_key(params) -> tuple:
    """What a graph bakes in of the params: every leaf's address, shape and
    type (rebinding a leaf needs a new graph)."""
    return tuple(((t.to_local() if isinstance(t, DTensor) else t)
                  .data_ptr(), t.shape, t.dtype)
                 for t in leaves(params))


def _geometry(tree) -> tuple:
    return tuple((t.shape, t.dtype) for t in leaves(tree))


@graphs.captured
def _step_body(params, cfg: ModelConfig, greedy: bool,
               rng: Optional[torch.Generator]):
    """The captured decode step: (cache, packed [3, B] int64: token, pos,
    active) -> (next_token [B, 1], cache, logits [B, V]). The eager step on
    those inputs, its new cache copied into ``cache`` at the end (the
    graph's static buffers); a sample draws from ``rng``."""
    def body(cache, packed):
        logits, new = M.decode_step(params, cfg, packed[0][:, None], cache,
                                    packed[1], active=packed[2].bool())
        _copy_into(cache, new)
        logits = logits[:, 0]
        return _pick(logits, greedy, rng)[:, None], cache, logits
    return body


def _pack(token, pos, active) -> torch.Tensor:
    """token [B, 1], pos [B] (or a scalar) and active [B] (None: all live)
    as one int64 [3, B]: stacked on the card for tensors there, on the host
    for numpy arrays and host tensors (one copy to the card a step). A
    DTensor token (a mesh step's) is taken whole."""
    if isinstance(token, DTensor):
        token = token.full_tensor()
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
    logits (the graph's buffer: the next call overwrites them).

    Sampled (``greedy=False`` with an ``rng``, a ``torch.Generator`` of the
    params' device): the graph draws from ``rng`` (one graph per
    generator, registered with it), so a replayed run samples the eager
    step's tokens on the same seed. ``prefill`` is a :class:`GraphedPrefill`
    of ``cfg`` that ``generate`` replays with this step, so a held step
    keeps the prefill's graphs too. On the CPU the body runs directly.
    """

    def __init__(self, cfg: ModelConfig, greedy: bool = True):
        self.cfg = cfg
        self.greedy = greedy
        self.graphs: dict = {}
        self.last_logits: Optional[torch.Tensor] = None
        self.prefill = GraphedPrefill(cfg)

    def graph_for(self, params, cache, rng=None) -> graphs.CapturedGraph:
        sample = None if self.greedy else rng
        key = (_params_key(params), _geometry(cache), id(sample))
        g = self.graphs.get(key)
        if g is None:
            B = leaves(cache)[0].shape[0]
            g = graphs.CapturedGraph(
                _step_body(params, self.cfg, self.greedy, sample),
                _device(params),
                f"{self.cfg.name} decode step (batch {B}"
                f"{', sampled' if sample is not None else ''})",
                adopt=(0,), keep=(leaves(params), sample),
                generator=sample)
            self.graphs[key] = g
        return g

    def __call__(self, params, cache, token, pos, active=None, rng=None):
        nxt, cache, self.last_logits = self.graph_for(params, cache, rng)(
            cache, _pack(token, pos, active))
        return nxt.clone(), cache


@graphs.captured
def _prefill_body(params, cfg: ModelConfig):
    """The captured cache-writing prefill: (cache, tokens [B, S]) ->
    (last_logits [B, V], the new cache in the graph's pool)."""
    def body(cache, tokens):
        return M.prefill(params, cfg, tokens, cache)
    return body


class GraphedPrefill:
    """The cache-writing prefill captured in a CUDA graph per prompt length
    and batch width: the port's counterpart of the reference's
    ``jitted_prefill`` (one compile per prompt length). Called as
    :func:`repro_torch.models.model.prefill` is: (params, tokens [B, S],
    cache) -> (last_logits [B, V], cache).

    One graph per (params leaves' addresses, the tokens' shape, the cache's
    geometry). The cache given is copied into the graph's input buffer and
    the prefilled cache copied back into it after the replay: the cache
    returned is the caller's own tensors, written in place (unlike
    ``prefill``, which leaves it), never a buffer of the graph's pool
    (which the next replay overwrites), so another graph may adopt it.
    ``last_logits`` is a copy. On the CPU the body runs directly.
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.graphs: dict = {}

    def graph_for(self, params, tokens, cache) -> graphs.CapturedGraph:
        key = (_params_key(params), tuple(tokens.shape), _geometry(cache))
        g = self.graphs.get(key)
        if g is None:
            g = graphs.CapturedGraph(
                _prefill_body(params, self.cfg), _device(params),
                f"{self.cfg.name} prefill (batch {tokens.shape[0]}, prompt "
                f"{tokens.shape[1]})", keep=leaves(params))
            self.graphs[key] = g
        return g

    def __call__(self, params, tokens, cache):
        last, new = self.graph_for(params, tokens, cache)(cache, tokens)
        return last.clone(), _copy_into(cache, new)


def write_lane(cache, lane, slot: int):
    """Write a one-lane cache over lane ``slot`` of ``cache`` in place
    (every leaf's row ``slot``); returns ``cache``."""
    def write(big, ln):
        big[slot] = ln[0].to(big.dtype)
    map_tree(write, cache, lane)
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
        return first, write_lane(map_tree(torch.clone, cache), lane, slot)
    return admit


@graphs.captured
def _admit_body(params, cfg: ModelConfig, max_len: int, greedy: bool):
    """The captured admission: (cache, packed [S + 1] int64: the prompt,
    then the slot) -> (first_token [1, 1], cache): a zeroed lane prefilled
    with the prompt and written over row ``slot`` of ``cache`` in place
    (:func:`write_lane`'s bits, the slot a tensor on the device)."""
    def body(cache, packed):
        prompt, slot = packed[None, :-1], packed[-1:]
        lane = M.init_cache(cfg, 1, max_len, device=packed.device)
        last, lane = M.prefill(params, cfg, prompt, lane)
        map_tree(lambda big, ln: big.index_copy_(0, slot, ln.to(big.dtype)),
                 cache, lane)
        return _pick(last, greedy, None)[:, None], cache
    return body


class GraphedAdmit:
    """Slot admission captured in a CUDA graph per prompt length: the
    port's counterpart of the reference's ``jitted_admit`` (its ``slot``
    traced, so one compile per prompt length, not per slot). (params,
    cache, prompt [1, S] or [S], slot) -> (first_token [1, 1], cache): the
    same tokens and cache as :func:`prefill_lane` then :func:`write_lane`.

    The cache is the caller's (the scheduler's), adopted by the graph as
    its buffer and written in place, as :class:`GraphedServeStep` adopts
    it; another cache of the same geometry is copied in. The prompt and the
    slot (an int, or a one-element tensor) go in as one packed copy. One
    graph per (params leaves' addresses, cache geometry, prompt length).
    On the CPU the body runs directly.
    """

    def __init__(self, cfg: ModelConfig, max_len: int, greedy: bool = True):
        if cfg.encoder_layers:
            raise ValueError("slot admission serves decoder-only models")
        self.cfg = cfg
        self.max_len = max_len
        self.greedy = greedy
        self.graphs: dict = {}

    def __call__(self, params, cache, prompt, slot):
        prompt = torch.as_tensor(prompt).reshape(-1)
        packed = torch.cat([prompt.long(), torch.as_tensor(
            slot, device=prompt.device).reshape(1).long()])
        key = (_params_key(params), _geometry(cache), prompt.shape[0])
        g = self.graphs.get(key)
        if g is None:
            g = graphs.CapturedGraph(
                _admit_body(params, self.cfg, self.max_len, self.greedy),
                _device(params), f"{self.cfg.name} admission (prompt "
                f"{prompt.shape[0]})", adopt=(0,),
                keep=leaves(params))
            self.graphs[key] = g
        first, cache = g(cache, packed)
        return first.clone(), cache


def make_ffn_stats_fn(cfg: ModelConfig):
    """Read-only instrumented decode step: (params, cache, token, pos
    [, active]) -> the sparse-FFN stats summed over all blocks. The step's
    logits and cache are discarded, so the serving state is untouched."""
    def stats_step(params, cache, token, pos, active=None):
        return M.decode_step(params, cfg, token, cache, pos, active=active,
                             return_ffn_stats=True)[2]
    return stats_step


@graphs.captured
def _ffn_stats_body(params, cfg: ModelConfig):
    """The captured probe: (cache, packed [3, B] int64) -> the stats of
    :func:`make_ffn_stats_fn`, 0-d tensors on the device."""
    def body(cache, packed):
        return M.decode_step(params, cfg, packed[0][:, None], cache,
                             packed[1], active=packed[2].bool(),
                             return_ffn_stats=True)[2]
    return body


class GraphedFfnStats:
    """The FFN probe captured in a CUDA graph per batch width: the port's
    counterpart of the reference's ``jitted_ffn_stats``. Called as
    :func:`make_ffn_stats_fn`'s function is: (params, cache, token, pos[,
    active]) -> {stat: 0-d tensor}, the graph's output buffers (read them
    before the next call). The cache is adopted and only read. On the CPU
    the body runs directly."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.graphs: dict = {}

    def __call__(self, params, cache, token, pos, active=None):
        key = (_params_key(params), _geometry(cache))
        g = self.graphs.get(key)
        if g is None:
            g = graphs.CapturedGraph(
                _ffn_stats_body(params, self.cfg), _device(params),
                f"{self.cfg.name} FFN probe (batch {token.shape[0]})",
                adopt=(0,), keep=leaves(params))
            self.graphs[key] = g
        return g(cache, _pack(token, pos, active))


def reset_slots(cache, free_mask: torch.Tensor):
    """Zero the cache lanes where ``free_mask`` [B] is True."""
    def zero(a):
        keep = (~free_mask.to(a.device).bool()).reshape(
            (-1,) + (1,) * (a.ndim - 1))
        return a * keep.to(a.dtype)
    return map_tree(zero, cache)


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
    captured prefill and decode step (:class:`GraphedServeStep` and its
    :class:`GraphedPrefill`), greedy or sampling with ``rng`` (a
    ``torch.Generator`` of the prompt's device: the eager run's tokens on
    the same seed). ``step`` is a :class:`GraphedServeStep` of ``cfg``
    the caller holds to keep its graphs across calls (by default a new
    one, dropped on return; a held one copies the prefilled cache into its
    decode graph's buffers once). ``compiled=False`` runs the eager
    functions (the comparison runs). An encoder-decoder first encodes
    ``src_embeds`` [B, S_enc, D] and writes each decoder block's cross K/V
    into the cache. ``prefix_embeds`` is refused: the cache-writing
    prefill takes no prefix (the reference's ``generate`` takes one and
    drops it); a prefix model's prefix runs through
    :func:`repro_torch.models.model.forward`."""
    if prefix_embeds is not None:
        raise ValueError("generate's prefill takes no prefix_embeds; run a "
                         "prefix through forward(prefix_embeds=...)")
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
    if compiled:
        last, cache = step.prefill(params, prompt, cache)
    else:
        last, cache = M.prefill(params, cfg, prompt, cache)
    tok = _pick(last, greedy, rng)[:, None].to(prompt.dtype)
    out = [prompt, tok]
    pos = torch.full((B,), S0, dtype=torch.long, device=prompt.device)
    for _ in range(max_new - 1):
        tok, cache = step(params, cache, tok, pos, None, rng)
        pos = pos + 1
        out.append(tok.to(prompt.dtype))
    return torch.cat(out, dim=1)
