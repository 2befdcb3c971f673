"""Fused sparse FFN in-projection (port of ``repro.kernels.fused_ffn``).

``act(x @ W_in [, x @ W_gate])`` in one launch: both projections share the
chunk-block-sparse layout and the ``sub_m``-row activation skip of
:mod:`repro_torch.kernels.bitmask_spmm`, both fp32 accumulators stay
resident, and the activation (and the gate multiply) is applied at the
flush, so the ``[M, F]`` pre-activations never reach device memory. The
output projection is a second, two-sided :func:`bitmask_spmm` launch fed
by the activation zeros.

On a CUDA tensor :func:`fused_ffn_spmm` launches ``csrc/fused_ffn.cu``; on
a CPU tensor it runs :func:`fused_ffn_spmm_plain`. :func:`fused_ffn_spmm_wl`
is the same function over a compacted (two-stream, for the gated acts)
work list, run by the walker of :mod:`repro_torch.kernels.worklist_core`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._cuda import (KERNEL_DTYPES, CudaKernel, I, P,
                                       check_cuda_tensor, ptr)
from repro_torch.kernels.bitmask_spmm import check_grid, subblock_macs
from repro_torch.kernels.grid import check_lm_grid, grid_geometry, sm_count
from repro_torch.kernels.worklist_core import (ACT_CODE, ACTS, DEFAULT_BM,
                                               GATED_ACTS, LANE, WorkList,
                                               _tile_output, activate,
                                               worklist_spmm)

FUSED_FFN = CudaKernel("fused_ffn.cu", "fused_ffn_spmm", [
    P, P, P, P, P, P, P,                 # x in_vals in_idx gate_vals gate_idx
                                         # occ out
    I, I, I, I, I, I, I, I, I,           # M K nb mb max_nz bk bn bm sub_m
    I, I, I, I,                          # two_sided act bf16 col_group
    P])                                  # stream


def align_chunk_lists(in_idx: torch.Tensor, in_vals: torch.Tensor,
                      gate_idx: torch.Tensor, gate_vals: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Pad the in and gate chunk lists to one slot axis: ``-1`` slots with
    zero tiles behind them (the reference's alignment, done offline by
    ``sparsify_model`` and here only when the lists still differ)."""
    mnz = max(in_idx.shape[1], gate_idx.shape[1])

    def pad_idx(i):
        return F.pad(i, (0, mnz - i.shape[1]), value=-1)

    def pad_vals(v):
        return F.pad(v, (0, 0, 0, 0, 0, mnz - v.shape[1]))

    return pad_idx(in_idx), pad_vals(in_vals), pad_idx(gate_idx), \
        pad_vals(gate_vals)


def fused_ffn_spmm_plain(x: torch.Tensor, in_idx: torch.Tensor,
                         in_vals: torch.Tensor,
                         gate_idx: Optional[torch.Tensor],
                         gate_vals: Optional[torch.Tensor], *, act: str,
                         bk: int, bn: int, bm: int, sub_m: int,
                         two_sided: bool) -> torch.Tensor:
    """Plain version of the kernel: each stream through
    :func:`~repro_torch.kernels.bitmask_spmm.subblock_macs` (fp32), the
    activation on the fp32 accumulators, the tile in ``x``'s type."""
    nb = in_idx.shape[0]
    kw = dict(bk=bk, bm=bm, sub_m=sub_m, two_sided=two_sided)
    h, _ = subblock_macs(x, in_idx, in_vals, **kw)
    g = subblock_macs(x, gate_idx, gate_vals, **kw)[0] \
        if gate_idx is not None else None
    a = activate(h, g, act)
    mb = a.shape[1]
    return _tile_output(a.reshape(nb * mb, bm, bn), nb, mb, bm, bn, sub_m,
                        False)[0].to(x.dtype)


def _fused_ffn_spmm_cuda(x, in_idx, in_vals, gate_idx, gate_vals, *, act,
                         bk, bn, bm, sub_m, two_sided):
    M, K = x.shape
    dev = x.device
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes {KERNEL_DTYPES}, got {x.dtype}")
    check_cuda_tensor("x", x, x.dtype, dev)
    check_cuda_tensor("in_idx", in_idx, torch.int32, dev)
    check_cuda_tensor("in_vals", in_vals, x.dtype, dev)
    nb, max_nz = in_idx.shape
    for name, idx, vals in (("in", in_idx, in_vals),
                            ("gate", gate_idx, gate_vals)):
        if idx is None:
            continue
        check_cuda_tensor(f"{name}_idx", idx, torch.int32, dev)
        check_cuda_tensor(f"{name}_vals", vals, x.dtype, dev)
        if tuple(idx.shape) != (nb, max_nz) or \
                tuple(vals.shape) != (nb, max_nz, bk, bn):
            raise ValueError(f"{name} lists {tuple(idx.shape)} / "
                             f"{tuple(vals.shape)} do not match ({nb}, "
                             f"{max_nz}) and tile ({bk}, {bn})")
    check_lm_grid(x, [("in_vals", in_vals), ("gate_vals", gate_vals)], bk,
                  bn)
    geom = grid_geometry(M, nb, bm=bm, bn=bn, sms=sm_count(dev))
    # scratch the kernel fills with the activation occupancy
    occ = torch.empty((M // sub_m, K // bk), dtype=torch.int32, device=dev)
    out = torch.empty((M, nb * bn), dtype=x.dtype, device=dev)
    FUSED_FFN.launch(dev, x.data_ptr(), in_vals.data_ptr(),
                     in_idx.data_ptr(), ptr(gate_vals), ptr(gate_idx),
                     occ.data_ptr(), out.data_ptr(), M, K, nb, M // bm,
                     max_nz, bk, bn, bm, sub_m, int(two_sided),
                     ACT_CODE[act], int(x.dtype == torch.bfloat16),
                     geom.col_group)
    return out


def fused_ffn_spmm(x: torch.Tensor, in_idx: torch.Tensor,
                   in_vals: torch.Tensor,
                   gate_idx: Optional[torch.Tensor] = None,
                   gate_vals: Optional[torch.Tensor] = None, *, act: str,
                   bk: int = LANE, bn: int = LANE, bm: int = DEFAULT_BM,
                   sub_m: Optional[int] = None,
                   two_sided: bool = True) -> torch.Tensor:
    """``act(x @ W_in [, x @ W_gate])`` with both weights chunk-block-sparse.

    x [M, K]; in_idx/gate_idx int32 [nb, max_nz]; in_vals/gate_vals
    [nb, max_nz, bk, bn]. The gated acts (swiglu, geglu) need the gate
    operands, the others must not get them. Returns the activated hidden
    ``[M, nb*bn]`` in ``x.dtype`` (both projections accumulate in fp32 and
    the activation is applied to the fp32 accumulators). A CUDA tensor
    launches ``csrc/fused_ffn.cu``, which takes the tilings
    :func:`~repro_torch.kernels.bitmask_spmm.bitmask_spmm` takes and raises
    ``ValueError`` for others; a CPU tensor runs the plain version.
    """
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    gated = act in GATED_ACTS
    if (gate_idx is not None) != gated or (gate_vals is not None) != gated:
        raise ValueError(f"act {act!r} {'needs' if gated else 'takes no'} "
                         "gate operands")
    sub_m = bm if sub_m is None else sub_m
    check_grid(x, bk, bm, sub_m)
    if gated and in_idx.shape[1] != gate_idx.shape[1]:
        in_idx, in_vals, gate_idx, gate_vals = align_chunk_lists(
            in_idx, in_vals, gate_idx, gate_vals)
    kw = dict(act=act, bk=bk, bn=bn, bm=bm, sub_m=sub_m, two_sided=two_sided)
    if x.device.type == "cpu":
        return fused_ffn_spmm_plain(x, in_idx, in_vals, gate_idx, gate_vals,
                                    **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no fused FFN kernel for device {x.device}")
    return _fused_ffn_spmm_cuda(x, in_idx, in_vals, gate_idx, gate_vals, **kw)


def fused_ffn_spmm_wl(x: torch.Tensor, in_vals: torch.Tensor, wl: WorkList,
                      gate_vals: Optional[torch.Tensor] = None, *, act: str,
                      bk: int = LANE, bn: int = LANE,
                      bm_rows: int = DEFAULT_BM) -> torch.Tensor:
    """Work-list-compacted fused FFN: ``act(x @ W_in [, x @ W_gate])``.

    ``wl`` comes from :func:`~repro_torch.kernels.worklist_core.build_worklist`
    — for the gated acts a two-stream list (``gate_indices`` at build time)
    whose slots are the union of the in and gate live sets, each stream
    adding its chunks in its own ascending-j order, so the fp32 sum order
    (and on the card the bits) matches :func:`fused_ffn_spmm`. Built at
    ``bm_rows = sub_m`` granularity the schedule holds exactly the live
    (row sub-block, k-chunk) pairs — the decode-path telescoping.
    """
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    gated = act in GATED_ACTS
    if (gate_vals is not None) != gated:
        raise ValueError(f"act {act!r} {'needs' if gated else 'takes no'} "
                         "gate operands")
    return worklist_spmm(x, in_vals, wl, vals2=gate_vals, bk=bk, bn=bn,
                         bm_rows=bm_rows, act=act)[0]
