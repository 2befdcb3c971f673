"""Public entry points of the sparse matmul kernels (port of
``repro.kernels.ops``).

``sparse_dense_matmul`` takes a :class:`repro_torch.core.bitmask.BlockSparseMatrix`
and dense activations, pads the rows to the kernel's block and K to the
packed chunk, and runs the predicated kernel;
``sparse_matmul_packed`` / ``fused_sparse_ffn`` do the same for raw packed
arrays, the form the model carries in its params
(``sparsity.sparse_ffn.sparsify_model``).

``sparse_matmul_packed_wl`` / ``fused_sparse_ffn_wl`` are the work-list
(compacted) variants: the schedule is built on the host at ``sub_m``-row
granularity, so a decode batch schedules only its live (row sub-block,
k-chunk) pairs, and the walker runs it (two weight streams for the gated
FFN). Eager only: the schedule is host data.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bitmask as bm
from repro_torch.kernels.bitmask_spmm import bitmask_spmm, bitmask_spmm_wl
from repro_torch.kernels.fused_ffn import (GATED_ACTS, align_chunk_lists,
                                           fused_ffn_spmm, fused_ffn_spmm_wl)
from repro_torch.kernels.worklist_core import (  # noqa: F401 (re-exports)
    DEFAULT_BM, WorkList, activation_occupancy, build_worklist,
    schedule_counters, schedule_stats)

# the reference's name for the schedule model (autotune and the vision
# stats path call it so)
conv_schedule_stats = schedule_stats


def _pad_rows_k(x: torch.Tensor, k_total: int, bm_rows: int):
    """Flatten the leading dims and pad rows to ``bm_rows`` and K to the
    packed ``k_total``; returns ``(x2, lead, M)``."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    pad = (-M) % bm_rows
    pad_k = k_total - K  # packed weights are chunk-padded on K
    if pad_k < 0:
        raise ValueError(f"x has {K} features, the packed weights {k_total}")
    if pad or pad_k:
        x2 = F.pad(x2, (0, pad_k, 0, pad))
    return x2.contiguous(), lead, M


def sparse_matmul_packed(x: torch.Tensor, indices: torch.Tensor,
                         vals: torch.Tensor, *, k_total: int, bk: int,
                         bn: int, bm_rows: int = 128,
                         sub_m: Optional[int] = None, two_sided: bool = True,
                         count_macs: bool = False):
    """x [..., K] @ sparse W [k_total, nb*bn] from raw packed arrays (one
    :func:`~repro_torch.kernels.bitmask_spmm.bitmask_spmm` launch). On a
    CUDA tensor ``bm_rows`` must divide 32 or be a multiple of 32 and
    ``bk``/``bn`` multiples of 8 (``bk <= 248``, ``bn <= 128``), else the
    kernel raises ``ValueError``; the CPU path takes any tiling."""
    x2, lead, M = _pad_rows_k(x, k_total, bm_rows)
    out = bitmask_spmm(x2, indices, vals, bk=bk, bn=bn, bm=bm_rows,
                       sub_m=sub_m, two_sided=two_sided,
                       count_macs=count_macs)
    counts = None
    if count_macs:
        out, counts = out
    out = out[:M].reshape(*lead, indices.shape[0] * bn)
    return (out, counts) if count_macs else out


def sparse_dense_matmul(x: torch.Tensor, w: bm.BlockSparseMatrix, *,
                        two_sided: bool = True, bm_rows: int = 128,
                        sub_m: Optional[int] = None,
                        count_macs: bool = False):
    """x [..., K] @ sparse W [K, N] -> [..., N]."""
    return sparse_matmul_packed(x, w.indices, w.vals, k_total=w.shape[0],
                                bk=w.bk, bn=w.bn, bm_rows=bm_rows,
                                sub_m=sub_m, two_sided=two_sided,
                                count_macs=count_macs)


def fused_sparse_ffn(x: torch.Tensor, in_idx: torch.Tensor,
                     in_vals: torch.Tensor,
                     gate_idx: Optional[torch.Tensor] = None,
                     gate_vals: Optional[torch.Tensor] = None, *, act: str,
                     k_total: int, bk: int, bn: int, bm_rows: int = 128,
                     sub_m: Optional[int] = None,
                     two_sided: bool = True) -> torch.Tensor:
    """``act(x @ W_in [, x @ W_gate])`` in one launch (fp32 accumulation);
    see :mod:`repro_torch.kernels.fused_ffn`. On a CUDA tensor the tiling
    limits of :func:`sparse_matmul_packed` hold (``bm_rows`` dividing or a
    multiple of 32, ``bk``/``bn`` multiples of 8), else ``ValueError``."""
    x2, lead, M = _pad_rows_k(x, k_total, bm_rows)
    h = fused_ffn_spmm(x2, in_idx, in_vals, gate_idx, gate_vals, act=act,
                       bk=bk, bn=bn, bm=bm_rows, sub_m=sub_m,
                       two_sided=two_sided)
    return h[:M].reshape(*lead, in_idx.shape[0] * bn)


def sparse_matmul_tile_stats(x: torch.Tensor, indices: torch.Tensor, *,
                             k_total: int, bk: int, bm_rows: int = 128,
                             sub_m: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
    """Model of the kernel's skip logic (no launch). fp32 scalars:

    * ``executed`` — (stored chunk x occupied row sub-block) MACs the
      two-sided kernel performs (its summed ``count_macs``),
    * ``weight_tile_macs`` — MACs a one-sided kernel performs (every stored
      chunk x every row sub-block),
    * ``dense_tile_macs`` — MACs of the dense matmul at the same tiling.
    """
    sub = bm_rows if sub_m is None else sub_m
    x2, _, _ = _pad_rows_k(x, k_total, bm_rows)
    kb = k_total // bk
    occ = (x2.reshape(-1, sub, kb, bk) != 0).any(dim=3).any(dim=1)
    msub = occ.shape[0]
    valid = indices >= 0
    # chunk usage histogram over all (n-block, j) weight entries
    cnt = torch.zeros((kb,), dtype=torch.float32, device=indices.device) \
        .index_add_(0, torch.where(valid, indices, 0).reshape(-1).long(),
                    valid.reshape(-1).float())
    executed = (occ.sum(0).float() * cnt).sum()
    weight = valid.sum().float() * msub
    dense = torch.full((), float(indices.shape[0] * kb * msub),
                       dtype=torch.float32, device=indices.device)
    return {"executed": executed, "weight_tile_macs": weight,
            "dense_tile_macs": dense}


def _predicated_steps(M: int, nb: int, max_nz: int, sub_m: int,
                      bm_rows: int = DEFAULT_BM) -> int:
    """Sub-block predication steps the dense-grid kernel iterates for one
    launch: rows padded to ``bm_rows`` blocks, ``bm_rows // sub_m`` in-lane
    sub-block steps per (n, m-block, j) grid cell — the denominator of the
    decode compaction factor."""
    mb128 = -(-M // bm_rows)
    return nb * mb128 * (bm_rows // sub_m) * max_nz


def _worklist_for(x2: torch.Tensor, indices: torch.Tensor,
                  gate_indices: Optional[torch.Tensor], sub_m: int, bk: int,
                  *, compact_activations: bool,
                  wl_cache: Optional[dict]) -> WorkList:
    """Schedule of an FFN-shaped work-list launch, ``x2`` already padded to
    ``sub_m``-row blocks and ``k_total`` columns. With
    ``compact_activations`` the per-pair lists also intersect the live
    activation sub-blocks of ``x2`` (data: built per call, from one host
    copy of the indices and the occupancy); without it the static
    pack-time schedule is cached in ``wl_cache`` per row-block count.
    Eager calls only: the schedule is host data."""
    if torch.jit.is_tracing() or torch.compiler.is_compiling():
        raise ValueError(
            "work-list FFN schedules are built on the host from concrete "
            "indices (and, when compact_activations, activations): eager "
            "calls only; under tracing or torch.compile use the dense "
            "schedule")
    mb = x2.shape[0] // sub_m
    if not compact_activations and wl_cache is not None and mb in wl_cache:
        return wl_cache[mb]
    if x2.is_cuda and torch.cuda.is_current_stream_capturing():
        raise ValueError(
            "a work-list FFN schedule is built on the host: build it with "
            "one eager call before CUDA-graph capture (static schedules, "
            "compact_activations=False, are then cached), or capture the "
            "dense schedule")
    parts = [indices.reshape(-1)]
    if gate_indices is not None:
        parts.append(gate_indices.reshape(-1))
    if compact_activations:
        occ = activation_occupancy(x2, sub_m, bk)
        parts.append(occ.reshape(-1).to(indices.device))
    host = torch.cat(parts).cpu().numpy()            # one copy to the host
    n_idx = indices.numel()
    streams = 1 if gate_indices is None else 2
    idx = host[:n_idx].reshape(indices.shape)
    gate = host[n_idx:2 * n_idx].reshape(indices.shape) \
        if streams == 2 else None
    occ_blk = host[streams * n_idx:].reshape(mb, -1).astype(bool) \
        if compact_activations else None
    # lint: ignore[EAGER-GUARD] no jax Tracer in torch; capture guarded above
    wl = build_worklist(idx, mb, occ_blk=occ_blk, gate_indices=gate)
    if not compact_activations and wl_cache is not None:
        wl_cache[mb] = wl
    return wl


def sparse_matmul_packed_wl(x: torch.Tensor, indices: torch.Tensor,
                            vals: torch.Tensor, *, k_total: int, bk: int,
                            bn: int, sub_m: int = 8,
                            compact_activations: bool = True,
                            wl_cache: Optional[dict] = None,
                            return_schedule: bool = False):
    """Work-list-compacted ``x @ W`` from raw packed arrays.

    The telescoped decode path: the schedule is built at ``sub_m``-row
    granularity, so a decode batch with one live lane schedules exactly its
    live (row sub-block, k-chunk) pairs, where :func:`sparse_matmul_packed`
    pads the batch to a 128-row block and predicates ``128 // sub_m``
    sub-block steps per slot. Bit for bit what the predicated kernel gives
    on the card. With ``return_schedule`` also returns the schedule-counters
    record, with the compaction factor against the predicated grid.
    """
    x2, lead, M = _pad_rows_k(x, k_total, sub_m)
    wl = _worklist_for(x2, indices, None, sub_m, bk,
                       compact_activations=compact_activations,
                       wl_cache=wl_cache)
    out = bitmask_spmm_wl(x2, vals, wl, bk=bk, bn=bn, bm_rows=sub_m)
    out = out[:M].reshape(*lead, indices.shape[0] * bn)
    if return_schedule:
        pred = _predicated_steps(M, *indices.shape, sub_m)
        return out, schedule_counters(wl, predicated_steps=pred)
    return out


def fused_sparse_ffn_wl(x: torch.Tensor, in_idx: torch.Tensor,
                        in_vals: torch.Tensor,
                        gate_idx: Optional[torch.Tensor] = None,
                        gate_vals: Optional[torch.Tensor] = None, *, act: str,
                        k_total: int, bk: int, bn: int, sub_m: int = 8,
                        compact_activations: bool = True,
                        wl_cache: Optional[dict] = None,
                        return_schedule: bool = False):
    """Work-list-compacted fused FFN (``act(x @ W_in [, x @ W_gate])``).

    The gated acts build a two-stream schedule over the union of the in and
    gate live sets (their chunk lists aligned on one slot axis first, as in
    :func:`fused_sparse_ffn`). Same eager-only, caching and compaction
    semantics as :func:`sparse_matmul_packed_wl`; bit for bit what the
    predicated fused kernel gives on the card.
    """
    gated = act in GATED_ACTS
    if (gate_idx is not None) != gated or (gate_vals is not None) != gated:
        raise ValueError(f"act {act!r} {'needs' if gated else 'takes no'} "
                         "gate operands")
    if gated and in_idx.shape[1] != gate_idx.shape[1]:
        in_idx, in_vals, gate_idx, gate_vals = align_chunk_lists(
            in_idx, in_vals, gate_idx, gate_vals)
    x2, lead, M = _pad_rows_k(x, k_total, sub_m)
    wl = _worklist_for(x2, in_idx, gate_idx, sub_m, bk,
                       compact_activations=compact_activations,
                       wl_cache=wl_cache)
    h = fused_ffn_spmm_wl(x2, in_vals, wl, gate_vals, act=act, bk=bk, bn=bn,
                          bm_rows=sub_m)
    h = h[:M].reshape(*lead, in_idx.shape[0] * bn)
    if return_schedule:
        pred = _predicated_steps(M, *in_idx.shape, sub_m)
        return h, schedule_counters(wl, predicated_steps=pred)
    return h
