"""Public entry points of the sparse matmul kernels (port of
``repro.kernels.ops``).

``sparse_dense_matmul`` takes a :class:`repro_torch.core.bitmask.BlockSparseMatrix`
and dense activations, pads the rows to the kernel's block and K to the
packed chunk, and runs the predicated kernel;
``sparse_matmul_packed`` / ``fused_sparse_ffn`` do the same for raw packed
arrays, the form the model carries in its params
(``sparsity.sparse_ffn.sparsify_model``).

The work-list (compacted) FFN variants need the walker's second stream,
which is not ported yet: ``sparse_matmul_packed_wl`` and
``fused_sparse_ffn_wl`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bitmask as bm
from repro_torch.kernels.bitmask_spmm import bitmask_spmm
from repro_torch.kernels.fused_ffn import fused_ffn_spmm
from repro_torch.kernels.worklist_core import (  # noqa: F401 (re-exports)
    DEFAULT_BM, activation_occupancy, schedule_stats)

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
    :func:`~repro_torch.kernels.bitmask_spmm.bitmask_spmm` launch)."""
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
    see :mod:`repro_torch.kernels.fused_ffn`."""
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
    dense = torch.tensor(float(indices.shape[0] * kb * msub),
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


def sparse_matmul_packed_wl(*args, **kwargs):
    """Work-list-compacted ``x @ W``: needs the walker's second stream,
    which a later slice ports."""
    raise NotImplementedError(
        "sparse_matmul_packed_wl needs the two-stream walker, not ported yet")


def fused_sparse_ffn_wl(*args, **kwargs):
    """Work-list-compacted fused FFN: needs the walker's second stream with
    the gated acts, which a later slice ports."""
    raise NotImplementedError(
        "fused_sparse_ffn_wl needs the two-stream walker, not ported yet")
