"""Whole-model builders (port of ``repro.models.model``): decoder LMs
(dense, MoE, Mamba/attention hybrid, RWKV6), the encoder-decoder and the
modality-prefix model, on one block library: params, the full-sequence
forward, the encoder, the decode cache, single-pass prefill and the
per-slot decode step.

Where the reference stacks block params over periods and scans them
(``lax.scan``), the port holds one entry per period in a list:
``params["blocks"][p]["p<i>"]`` is block i of period p's pattern (an
encoder-decoder's encoder likewise under ``params["enc_blocks"][p]["p0"]``),
and the decode cache is laid out the same way: ``cache[p]["p<i>"]["k"]``
is [B, S_max, Hkv, dh] for an attention block (with ``cross_k`` /
``cross_v`` [B, S_enc, Hkv, dh] in an encoder-decoder), a Mamba block keeps
``conv`` [B, d_conv-1, din] and ``h`` [B, din, ds] fp32, an RWKV block
``wkv`` [B, H, N, N] fp32 and the two token-shift rows ``shift_t`` /
``shift_c`` [B, D].
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import act_sharding, partitioning
from repro_torch.models import layers as L
from repro_torch.tree import map_tree

Params = Dict[str, Any]
Cache = List[Dict[str, Dict[str, torch.Tensor]]]
META = torch.device("meta")


def _uses_moe(cfg: ModelConfig, pos: int) -> bool:
    """MoE replaces the FFN at pattern positions every-1, 2*every-1, ..."""
    if cfg.moe is None:
        return False
    every = cfg.moe.every
    if every != 1 and len(cfg.block_pattern) % every:
        raise ValueError(f"{cfg.name}: MoE every {every} does not divide "
                         f"the pattern {cfg.block_pattern}")
    return pos % every == every - 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, pos: int,
                dtype: torch.dtype, cross: bool = False) -> Params:
    """One block: the mixer (attention, Mamba or RWKV time-mix), then the
    FFN, MoE or RWKV channel-mix; with ``cross`` a cross-attention and its
    norm (decoder blocks of an encoder-decoder)."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype,  # noqa: E731
                              device=gen.device)
    if kind == "rwkv":
        return {"ln1": ones(), "time_mix": L.init_rwkv(gen, cfg, dtype),
                "ln2": ones(),
                "channel_mix": L.init_rwkv_channel(gen, cfg, dtype)}
    p: Params = {"ln1": ones()}
    if kind == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype)
    elif kind == "mamba":
        p["mamba"] = L.init_mamba(gen, cfg, dtype)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p["ln2"] = ones()
    if _uses_moe(cfg, pos):
        p["moe"] = L.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = L.init_ffn(gen, cfg, dtype)
    if cross:
        p["cross"] = L.init_attention(gen, cfg, dtype)
        p["ln_cross"] = ones()
    return p


def _init_stack(gen: torch.Generator, cfg: ModelConfig, periods: int,
                pattern, dtype: torch.dtype, cross: bool = False) -> list:
    return [{f"p{i}": _init_block(gen, cfg, kind, i, dtype, cross)
             for i, kind in enumerate(pattern)} for _ in range(periods)]


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Params:
    """Random params of ``cfg`` on ``device``, drawn from a generator
    seeded with ``seed`` on that device (the numbers differ from the
    reference's ``jax.random`` ones; ``convert.params_from_reference``
    carries those across). An encoder-decoder also gets ``enc_blocks`` and
    ``enc_norm``, a MoE model the identity ``expert_perm`` (int32 [E])."""
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    dev = gen.device
    V = cfg.padded_vocab
    params: Params = {
        "embed": (torch.randn((V, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "blocks": _init_stack(gen, cfg, cfg.periods, cfg.block_pattern,
                              dtype, cross=cfg.encoder_layers > 0),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, V, dtype)
    if cfg.encoder_layers:
        params["enc_blocks"] = _init_stack(gen, cfg, cfg.encoder_layers,
                                           ("attn",), dtype)
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                        device=dev)
    if cfg.moe is not None:
        # the greedy-balance slot permutation, identity until
        # sparsity.expert_balance.rebalance rewrites it from observed load
        params["expert_perm"] = torch.arange(cfg.moe.num_experts,
                                             dtype=torch.int32, device=dev)
    return params


class _NoDraw(TorchFunctionMode):
    """Inside, every call that names a device or a generator builds its
    tensor on the meta device, without the generator: no draw and no
    allocation."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs or "generator" in kwargs:
            kwargs.pop("generator", None)
            kwargs["device"] = META
        return func(*args, **kwargs)


def abstract_params(cfg: ModelConfig) -> Params:
    """The params tree of ``cfg`` as tensors on ``torch.device("meta")``:
    every leaf's shape and dtype and no allocation (the templates of
    ``ckpt.restore``; the full configs of 340B+ parameters too). A
    generator cannot live on the meta device, so :func:`init_params` runs
    with its CPU generator unused: each draw and each factory call inside
    goes to the meta device without it."""
    with _NoDraw():
        return init_params(cfg, device="cpu")


def _sparse_of(bp: Params, cfg: ModelConfig,
               key: str = "ffn_sparse") -> Optional[Params]:
    """Packed sparse-FFN leaves of this block when the BARISTA serving path
    is on: it needs both ``cfg.sparse_ffn`` and a ``sparsify_model`` pass
    over the params (dense params under a sparse config stay dense)."""
    if not cfg.sparse_ffn:
        return None
    return bp.get(key)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; a DTensor ``embed`` (vocab-sharded) by
    :func:`_embed_mesh`."""
    if isinstance(embed, DTensor):
        return _embed_mesh(embed, tokens)
    return embed[tokens]


def _embed_mesh(embed: DTensor, tokens: torch.Tensor) -> DTensor:
    """The vocab-parallel lookup (Megatron's): each rank gathers the rows
    of its own vocab block for its own batch rows, zeros for tokens outside
    the block, and the partial rows are summed over the vocab dims. Done on
    local tensors: DTensor's rule for the gradient of an index into a
    sharded table fails on some torch releases. The table's gradient is a
    partial sum over the dims that split the batch. A mesh of one rank
    computes ``embed[tokens]`` and its gradient bit for bit."""
    mesh = embed.device_mesh
    vocab = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0
                  else Replicate() for pl in embed.placements)
    tok_place = tuple(tokens.placements) if isinstance(tokens, DTensor) \
        else (Replicate(),) * mesh.ndim
    tok = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    grad = tuple(v if isinstance(v, Shard) else
                 Partial() if isinstance(t, Shard) else Replicate()
                 for v, t in zip(vocab, tok_place))
    # no redistribution where the table is already vocab-sharded: its
    # backward would reduce this partial gradient, and the optimizer once
    # more after the head's is added
    table = (embed if tuple(embed.placements) == vocab else
             embed.redistribute(mesh, vocab)).to_local(grad_placements=grad)
    first = partitioning.local_slices(mesh, vocab, embed.shape)[0].start
    idx = tok - first
    inside = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(inside, idx, 0)]
    if any(isinstance(v, Shard) for v in vocab):
        rows = torch.where(inside[..., None], rows, 0)
    out_place = tuple(Partial() if isinstance(v, Shard) else t
                      for v, t in zip(vocab, tok_place))
    out = DTensor.from_local(rows, mesh, out_place, run_check=False)
    return out.redistribute(mesh, tuple(
        Replicate() if isinstance(pl, Partial) else pl for pl in out_place))


def sharded(params):
    """The context a step on ``params`` runs in: ``implicit_replication``
    when they are DTensors (a plain tensor built in the step, its
    positions, masks and RoPE tables, counts as replicated), else
    nothing. Inside one already, nothing: leaving the context turns the
    switch off, so it must not nest."""
    if isinstance(params["embed"], DTensor) and not getattr(
            DTensor._op_dispatcher, "_allow_implicit_replication", False):
        return implicit_replication()
    return contextlib.nullcontext()


def _on_mesh(fn: Callable) -> Callable:
    """Run ``fn(params, ...)`` in :func:`sharded` of its params."""
    @functools.wraps(fn)
    def run(params, *args, **kwargs):
        with sharded(params):
            return fn(params, *args, **kwargs)
    return run


# a DTensor's positions gathered (the SP residual), before one is picked
positions_whole = L.positions_whole


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["lm_head"] if not cfg.tie_embeddings else params["embed"].t()
    return (x @ head.to(cfg.torch_dtype)).float()


def _cross(bp: Params, x, cfg: ModelConfig, kv):
    """The decoder block's cross-attention residual over encoder K/V."""
    hc = L.rmsnorm(x, bp["ln_cross"], cfg.norm_eps)
    return x + act_sharding.settle(L.attention(
        bp["cross"], hc, cfg, positions=None, mask=None, kv=kv,
        use_rope=False))


def _ffn_part(bp: Params, x, cfg: ModelConfig, expert_perm, stats=None):
    """The block's second half: the FFN (its sparse leaves when the BARISTA
    path is on) or the MoE -> (x, MoE aux loss or None)."""
    h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    if "moe" in bp:
        y, aux = L.moe_ffn(bp["moe"], h2, cfg, expert_perm)
        return x + act_sharding.settle(y), aux
    return x + act_sharding.settle(L.ffn(bp["ffn"], h2, cfg,
                                         sparse=_sparse_of(bp, cfg),
                                         stats=stats)), None


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
    x = x + act_sharding.settle(y)
    h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    y2, st2 = L.rwkv_channel_mix(
        bp["channel_mix"], h2, cfg,
        state=None if entry is None else {"shift": entry["shift_c"]},
        sparse=_sparse_of(bp, cfg, "channel_mix_sparse"), stats=stats)
    new = None if entry is None else {"wkv": st["wkv"],
                                      "shift_t": st["shift"],
                                      "shift_c": st2["shift"]}
    return x + act_sharding.settle(y2), new


def _block_fwd(bp: Params, x, cfg: ModelConfig, kind: str, *, positions,
               mask, expert_perm=None, enc_out=None,
               ssm_chunk: Optional[int] = None,
               flash_chunk: Optional[int] = None):
    """One block of the full-sequence forward -> (x, MoE aux or None)."""
    if kind == "rwkv":
        return _rwkv_block(bp, None, x, cfg, ssm_chunk or 64)[0], None
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if kind == "attn":
        y = L.attention(bp["attn"], h, cfg, positions=positions, mask=mask,
                        flash_chunk=flash_chunk)
    else:
        y = L.mamba_block(bp["mamba"], h, cfg, chunk=ssm_chunk or 64)
    x = x + act_sharding.settle(y)
    if enc_out is not None:
        x = _cross(bp, x, cfg, L.cross_kv(bp["cross"], enc_out, cfg))
    return _ffn_part(bp, x, cfg, expert_perm)


@_on_mesh
def encode(params: Params, src_embeds: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Encoder pass of an encoder-decoder: bidirectional self-attention
    (with RoPE) over ``src_embeds`` [B, S_enc, D] (the modality frontend's
    stub embeddings), then ``enc_norm``."""
    B, S, _ = src_embeds.shape
    positions = torch.arange(S, device=src_embeds.device)[None].expand(B, S)
    x = src_embeds.to(cfg.torch_dtype)
    for period in params["enc_blocks"]:
        x, _ = _block_fwd(period["p0"], x, cfg, "attn", positions=positions,
                          mask=None)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


@_on_mesh
def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            src_embeds: Optional[torch.Tensor] = None,
            remat: bool = False,
            remat_group: int = 1,
            ssm_chunk: Optional[int] = None,
            flash_chunk: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits [B, S_text, V] fp32, MoE aux loss
    summed over the blocks).

    ``remat``: activation checkpointing, one
    ``torch.utils.checkpoint.checkpoint`` per group of ``remat_group``
    periods (which must divide the periods): only the residual stream
    entering each group is kept for the backward, the rest is recomputed,
    as the reference's ``jax.checkpoint`` with ``nothing_saveable`` over its
    scan. The reference's ``unroll`` and ``flash_unroll`` exist for XLA's
    cost analysis only and have no counterpart.

    ``prefix_embeds`` [B, P, D]: a modality prefix ahead of the tokens that
    attends bidirectionally (PaliGemma); its rows are stripped before the
    head. ``src_embeds`` [B, S_enc, D]: the encoder input of an
    encoder-decoder. ``ssm_chunk``: the Mamba / WKV chunk (default 64).
    ``flash_chunk``: online-softmax self-attention in key tiles of that
    size (not with a prefix, which keeps the dense masked path).
    """
    dtype = cfg.torch_dtype
    B, S_text = tokens.shape
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens).to(dtype)
    prefix = 0
    if prefix_embeds is not None:
        prefix = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    S = S_text + prefix
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    use_flash = flash_chunk is not None and cfg.n_heads and prefix == 0
    mask = None
    if cfg.n_heads and not use_flash:
        mask = L.causal_mask(S, S, cfg.window, device=dev)
        if prefix:
            mask = mask | (torch.arange(S, device=dev) < prefix)
    enc_out = None
    if cfg.encoder_layers:
        if src_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward "
                             "needs src_embeds")
        enc_out = encode(params, src_embeds, cfg)
    expert_perm = params.get("expert_perm")

    def run(group, x, aux):
        for period in group:
            for i, kind in enumerate(cfg.block_pattern):
                x, a = _block_fwd(
                    period[f"p{i}"], x, cfg, kind, positions=positions,
                    mask=mask, expert_perm=expert_perm, enc_out=enc_out,
                    ssm_chunk=ssm_chunk,
                    flash_chunk=flash_chunk if use_flash else None)
                # sequence-parallel between blocks under act_sharding
                x = act_sharding.constrain_residual(x)
                if a is not None:
                    aux = aux + a
        return x, aux

    blocks = params["blocks"]
    if remat_group < 1 or len(blocks) % remat_group:
        raise ValueError(f"remat_group {remat_group} does not divide "
                         f"{len(blocks)} periods")
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for g in range(0, len(blocks), remat_group):
        group = blocks[g:g + remat_group]
        if remat:
            # the forward draws no random numbers, so the RNG state is not
            # stashed around the group (which a captured step cannot do)
            x, aux = checkpoint(run, group, x, aux, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = run(group, x, aux)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if prefix:
        x = positions_whole(x)[:, prefix:]
    return _head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode (single-token step with explicit state)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, device="cuda") -> Cache:
    """Zeroed decode state, per period and pattern position: an attention
    block's K and V caches [batch, max_len, Hkv, dh] (an encoder-decoder's
    also ``cross_k``/``cross_v`` [batch, enc_len, Hkv, dh], filled by
    :func:`prefill_cache`), a Mamba block's ``conv`` [batch, d_conv-1, din]
    and ``h`` [batch, din, ds] (fp32), an RWKV block's WKV state [batch, H,
    N, N] (fp32) and token-shift rows ``shift_t``/``shift_c`` [batch, D]."""
    def zeros(*shape, dtype=cfg.torch_dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def entry(kind):
        if kind == "rwkv":
            return {"wkv": zeros(batch, cfg.n_heads, cfg.d_head, cfg.d_head,
                                 dtype=torch.float32),
                    "shift_t": zeros(batch, cfg.d_model),
                    "shift_c": zeros(batch, cfg.d_model)}
        if kind == "mamba":
            m = cfg.mamba
            din = m.expand * cfg.d_model
            return {"conv": zeros(batch, m.d_conv - 1, din),
                    "h": zeros(batch, din, m.d_state, dtype=torch.float32)}
        e = {"k": zeros(batch, max_len, cfg.n_kv_heads, cfg.d_head),
             "v": zeros(batch, max_len, cfg.n_kv_heads, cfg.d_head)}
        if cfg.encoder_layers:
            e["cross_k"] = zeros(batch, enc_len, cfg.n_kv_heads, cfg.d_head)
            e["cross_v"] = zeros(batch, enc_len, cfg.n_kv_heads, cfg.d_head)
        return e

    return [{f"p{i}": entry(kind) for i, kind in enumerate(cfg.block_pattern)}
            for _ in range(cfg.periods)]


@_on_mesh
def prefill_cache(params: Params, cfg: ModelConfig, cache: Cache,
                  enc_out: torch.Tensor) -> Cache:
    """Encoder-decoder: each decoder attention block's cross K/V of the
    encoder output ``enc_out`` [B, S_enc, D] written into a new cache (the
    given one is not modified)."""
    new = []
    for period, entries in zip(params["blocks"], cache):
        entries = dict(entries)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}"
            if kind != "attn" or not cfg.encoder_layers:
                continue
            e = dict(entries[key])
            k, v = L.cross_kv(period[key]["cross"], enc_out, cfg)
            e["cross_k"] = L.placed_like(k.to(e["cross_k"].dtype),
                                        e["cross_k"])
            e["cross_v"] = L.placed_like(v.to(e["cross_v"].dtype),
                                        e["cross_v"])
            entries[key] = e
        new.append(entries)
    return new


def _block_decode(bp: Params, entry, x, cfg: ModelConfig, kind: str, pos,
                  expert_perm=None, stats=None):
    if kind == "rwkv":
        return _rwkv_block(bp, entry, x, cfg, 1, stats=stats)
    new = dict(entry)
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, new["k"], new["v"] = L.attention_decode(
            bp["attn"], h, cfg, cache_k=entry["k"], cache_v=entry["v"],
            pos=pos)
        x = x + act_sharding.settle(y)
        if "cross_k" in entry:
            x = _cross(bp, x, cfg, (entry["cross_k"], entry["cross_v"]))
    else:
        y, new["conv"], new["h"] = L.mamba_decode(bp["mamba"], h, cfg,
                                                  entry["conv"], entry["h"])
        x = x + act_sharding.settle(y)
    x, _ = _ffn_part(bp, x, cfg, expert_perm, stats=stats)
    return x, new


@_on_mesh
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
    scalars on the device; zeros of the three tile-MAC keys when the
    params carry no sparse leaves).
    """
    B = token.shape[0]
    dev = token.device
    pos = torch.as_tensor(pos, device=dev).long().expand(B)
    x = embed_lookup(params["embed"], token).to(cfg.torch_dtype)
    expert_perm = params.get("expert_perm")
    stats: Optional[list] = [] if return_ffn_stats else None
    new_cache = []
    for period, entries in zip(params["blocks"], cache):
        new = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}"
            x, new[key] = _block_decode(period[key], entries[key], x, cfg,
                                        kind, pos, expert_perm, stats=stats)
        new_cache.append(new)
    if active is not None:
        keep = active.to(dev).bool()
        new_cache = map_tree(lambda n, o: _keep_lanes(keep, n, o),
                             new_cache, cache)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, cfg, x)
    if not return_ffn_stats:
        return logits, new_cache
    # the sums stay on the device (a captured probe reads them after the
    # replay)
    if stats:
        totals = {k: sum(s[k] for s in stats) for k in stats[0]}
    else:
        totals = {k: torch.zeros((), dtype=torch.float32, device=dev) for k
                  in ("executed", "weight_tile_macs", "dense_tile_macs")}
    return logits, new_cache, totals


def _keep_lanes(keep: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """``new`` on the lanes ``keep`` [B] marks, ``old`` elsewhere. Placed
    (DTensor) leaves on each rank's block of lanes, in ``new``'s
    placements (the leaf's own)."""
    if not isinstance(new, DTensor):
        return torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                           old)
    mesh, place = new.device_mesh, tuple(new.placements)
    rows = partitioning.local_slices(mesh, place, new.shape)[0]
    local = torch.where(
        keep[rows].reshape((-1,) + (1,) * (new.ndim - 1)), new.to_local(),
        L._local_state(old, mesh, place))
    return DTensor.from_local(local, mesh, place, run_check=False)


# ---------------------------------------------------------------------------
# prefill (single-pass prompt -> cache)
# ---------------------------------------------------------------------------
def _block_prefill(bp: Params, entry, x, cfg: ModelConfig, kind: str, *,
                   positions, mask, expert_perm=None,
                   ssm_chunk: Optional[int] = None,
                   flash_chunk: Optional[int] = None):
    if kind == "rwkv":
        return _rwkv_block(bp, entry, x, cfg, ssm_chunk or 64)
    new = dict(entry)
    h = L.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, k, v = L.attention(bp["attn"], h, cfg, positions=positions,
                              mask=mask, flash_chunk=flash_chunk,
                              return_kv=True)
        new["k"] = L.write_rows(entry["k"], k)
        new["v"] = L.write_rows(entry["v"], v)
        x = x + act_sharding.settle(y)
        if "cross_k" in entry:
            x = _cross(bp, x, cfg, (entry["cross_k"], entry["cross_v"]))
    else:
        y, conv, hs = L.mamba_block(
            bp["mamba"], h, cfg, chunk=ssm_chunk or 64, return_state=True)
        new["conv"] = L.placed_like(conv, entry["conv"])
        new["h"] = L.placed_like(hs, entry["h"])
        x = x + act_sharding.settle(y)
    x, _ = _ffn_part(bp, x, cfg, expert_perm)
    return x, new


@_on_mesh
def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, *, ssm_chunk: Optional[int] = None,
            flash_chunk: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """One forward pass over the prompt that fills the decode cache.

    tokens [B, S] -> (last_logits [B, V], cache with rows [0, S) written
    and Mamba / RWKV states advanced past position S-1, in chunks of
    ``ssm_chunk``, default 64). ``flash_chunk`` switches self-attention to
    the online-softmax path. Lanes are expected to start from a zeroed
    cache (:func:`init_cache`; an encoder-decoder's cross K/V from
    :func:`prefill_cache`).
    """
    B, S = tokens.shape
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens).to(cfg.torch_dtype)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    use_flash = flash_chunk is not None and cfg.n_heads
    mask = L.causal_mask(S, S, cfg.window, device=dev) \
        if cfg.n_heads and not use_flash else None
    expert_perm = params.get("expert_perm")
    new_cache = []
    for period, entries in zip(params["blocks"], cache):
        new = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}"
            x, new[key] = _block_prefill(
                period[key], entries[key], x, cfg, kind,
                positions=positions, mask=mask, expert_perm=expert_perm,
                ssm_chunk=ssm_chunk,
                flash_chunk=flash_chunk if use_flash else None)
        new_cache.append(new)
    # project only the last position (the next-token logits serving needs)
    x = L.rmsnorm(positions_whole(x)[:, -1], params["final_norm"],
                  cfg.norm_eps)
    return _head(params, cfg, x), new_cache
