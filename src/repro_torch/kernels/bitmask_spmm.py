"""Predicated chunk-block-sparse matmul (port of ``repro.kernels.bitmask_spmm``).

``x [M, K] @ W [K, N]`` with ``W`` stored chunk-block-sparse (only the
(k-chunk, n-block) tiles holding a non-zero; see
:class:`repro_torch.core.bitmask.BlockSparseMatrix`). The grid is the
dense ``(nb, mb, max_nz)`` one: every slot of every n-block is visited, a
``-1`` slot does nothing, and in the two-sided mode each ``sub_m``-row
sub-block of a row block whose activation chunk is all zero is skipped —
one live decode lane padded into a 128-row block MACs its own ``sub_m``
rows, not the whole block. Arithmetic is fp32 whatever the storage type;
the output has ``x``'s type.

:func:`subblock_macs` is that skip predicate with its MACs, in plain
PyTorch: the plain version of this kernel, of the fused FFN kernel
(:mod:`repro_torch.kernels.fused_ffn`) and of the conv dense grid
(:mod:`repro_torch.kernels.sparse_conv`). On a CUDA tensor
:func:`bitmask_spmm` launches ``csrc/bitmask_spmm.cu``.

:func:`bitmask_spmm_wl` is the same product over a compacted work list
(the walker of :mod:`repro_torch.kernels.worklist_core`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._cuda import (KERNEL_DTYPES, CudaKernel, I, P,
                                       check_cuda_tensor, ptr)
from repro_torch.kernels.grid import check_lm_grid, grid_geometry, sm_count
from repro_torch.kernels.worklist_core import (DEFAULT_BM, LANE, WorkList,
                                               _tile_output,
                                               activation_occupancy,
                                               worklist_spmm)

BITMASK_SPMM = CudaKernel("bitmask_spmm.cu", "bitmask_spmm", [
    P, P, P, P, P, P,                    # x vals indices occ out counts
    I, I, I, I, I, I, I, I, I,           # M K nb mb max_nz bk bn bm sub_m
    I, I, I, I,                          # two_sided count_macs bf16
                                         # col_group
    P])                                  # stream


def check_grid(x: torch.Tensor, bk: int, bm: int, sub_m: int) -> None:
    """The dense grid tiles ``x`` by ``bm`` rows and ``bk`` columns, and a
    row block by ``sub_m``-row sub-blocks."""
    M, K = x.shape
    if M % bm or K % bk or bm % sub_m:
        raise ValueError(f"x [{M}, {K}] does not tile by bm={bm}, bk={bk}, "
                         f"sub_m={sub_m}")


def subblock_macs(x: torch.Tensor, indices: torch.Tensor,
                  vals: torch.Tensor, *, bk: int, bm: int, sub_m: int,
                  two_sided: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The predicated dense grid in plain PyTorch, on any device.

    For each slot ``j`` of every n-block, MAC chunk ``k = indices[n, j]``
    of every row block into an fp32 accumulator (operands widened to
    fp32): a ``-1`` slot adds nothing; when ``two_sided`` each ``sub_m``-row
    sub-block whose activation occupancy bit ``occ[row // sub_m, k]`` is
    clear is masked out. Returns ``(acc fp32 [nb, mb, bm, bn], counts int32
    [nb, mb])``: executed sub-block MACs when two-sided, one per valid slot
    (a whole-tile MAC) when one-sided — the TPU kernel's ``count_macs``.
    """
    M, K = x.shape
    nb, max_nz = indices.shape
    bn = vals.shape[-1]
    mb, kb, nsub = M // bm, K // bk, bm // sub_m
    x4 = x.reshape(mb, bm, kb, bk)
    occ3 = activation_occupancy(x, sub_m, bk).bool().reshape(mb, nsub, kb)
    acc = torch.zeros((nb, mb, bm, bn), dtype=torch.float32, device=x.device)
    counts = torch.zeros((nb, mb), dtype=torch.int32, device=x.device)
    for j in range(max_nz):
        k = indices[:, j].long()
        valid = k >= 0                                       # [nb]
        ks = k.clamp_min(0)
        xg = x4[:, :, ks, :].permute(2, 0, 1, 3).float()     # [nb, mb, bm, bk]
        if two_sided:
            live = occ3[:, :, ks].permute(2, 0, 1) & valid[:, None, None]
            rows = live.repeat_interleave(sub_m, dim=2)      # [nb, mb, bm]
            counts += live.sum(-1, dtype=torch.int32)
        else:
            rows = valid[:, None, None].expand(nb, mb, bm)
            counts += valid[:, None].to(torch.int32)
        acc += torch.matmul(xg * rows[..., None].float(),
                            vals[:, j][:, None].float())
    return acc, counts


def bitmask_spmm_plain(x: torch.Tensor, indices: torch.Tensor,
                       vals: torch.Tensor, *, bk: int, bn: int, bm: int,
                       sub_m: int, two_sided: bool, count_macs: bool):
    """Plain version of the kernel: :func:`subblock_macs`, then the tile
    written in ``x``'s type."""
    nb = indices.shape[0]
    acc, counts = subblock_macs(x, indices, vals, bk=bk, bm=bm, sub_m=sub_m,
                                two_sided=two_sided)
    mb = acc.shape[1]
    out = _tile_output(acc.reshape(nb * mb, bm, bn), nb, mb, bm, bn, sub_m,
                       False)[0].to(x.dtype)
    return (out, counts) if count_macs else out


def _bitmask_spmm_cuda(x, indices, vals, *, bk, bn, bm, sub_m, two_sided,
                       count_macs):
    M, K = x.shape
    dev = x.device
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes {KERNEL_DTYPES}, got {x.dtype}")
    check_cuda_tensor("x", x, x.dtype, dev)
    check_cuda_tensor("indices", indices, torch.int32, dev)
    check_cuda_tensor("vals", vals, x.dtype, dev)
    nb, max_nz = indices.shape
    if tuple(vals.shape) != (nb, max_nz, bk, bn):
        raise ValueError(f"vals {tuple(vals.shape)} does not match indices "
                         f"({nb}, {max_nz}) and tile ({bk}, {bn})")
    check_lm_grid(x, [("vals", vals)], bk, bn)
    geom = grid_geometry(M, nb, bm=bm, bn=bn, sms=sm_count(dev))
    # scratch the kernel fills: the activation occupancy (and the counts)
    occ = torch.empty((M // sub_m, K // bk), dtype=torch.int32, device=dev)
    out = torch.empty((M, nb * bn), dtype=x.dtype, device=dev)
    counts = torch.empty((nb, M // bm), dtype=torch.int32, device=dev) \
        if count_macs else None
    BITMASK_SPMM.launch(dev, x.data_ptr(), vals.data_ptr(),
                        indices.data_ptr(), occ.data_ptr(), out.data_ptr(),
                        ptr(counts), M, K, nb, M // bm, max_nz, bk, bn, bm,
                        sub_m, int(two_sided), int(count_macs),
                        int(x.dtype == torch.bfloat16), geom.col_group)
    return (out, counts) if count_macs else out


def bitmask_spmm(x: torch.Tensor, indices: torch.Tensor, vals: torch.Tensor,
                 *, bk: int = LANE, bn: int = LANE, bm: int = DEFAULT_BM,
                 sub_m: Optional[int] = None, two_sided: bool = False,
                 count_macs: bool = False):
    """``x [M, K] @ W [K, N]`` with W in chunk-block-sparse layout.

    indices: int32 [n_blocks, max_nz] (k-chunk ids, -1 padded);
    vals: [n_blocks, max_nz, bk, bn] in ``x``'s type. ``sub_m`` (default
    ``bm``) sets the row granularity of the two-sided skip. Returns
    ``[M, N]`` in ``x.dtype`` (fp32 accumulation) and, with ``count_macs``,
    the int32 ``[nb, mb]`` executed sub-block MACs. A CUDA tensor launches
    ``csrc/bitmask_spmm.cu`` (fp32 or bf16), which takes ``bm`` dividing 32
    or a multiple of 32, ``bk`` and ``bn`` multiples of 8 (``bk <= 248``,
    ``bn <= 128``) and 16-byte-aligned operands, and raises ``ValueError``
    otherwise (``bm=48``, say); a CPU tensor runs :func:`bitmask_spmm_plain`,
    which takes any tiling.
    """
    sub_m = bm if sub_m is None else sub_m
    check_grid(x, bk, bm, sub_m)
    kw = dict(bk=bk, bn=bn, bm=bm, sub_m=sub_m, two_sided=two_sided,
              count_macs=count_macs)
    if x.device.type == "cpu":
        return bitmask_spmm_plain(x, indices, vals, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no bitmask_spmm kernel for device {x.device}")
    return _bitmask_spmm_cuda(x, indices, vals, **kw)


def bitmask_spmm_wl(x: torch.Tensor, vals: torch.Tensor, wl: WorkList, *,
                    bk: int = LANE, bn: int = LANE,
                    bm_rows: int = DEFAULT_BM) -> torch.Tensor:
    """Work-list-compacted ``x @ W``: the FFN-shaped frontend of
    :func:`~repro_torch.kernels.worklist_core.worklist_spmm`.

    Where :func:`bitmask_spmm` runs the dense ``(nb, mb, max_nz)`` grid and
    predicates dead sub-blocks in-lane, this runs exactly ``wl.num_steps``
    scheduled steps. Built at ``bm_rows = sub_m`` granularity, a decode
    batch schedules exactly its live (row sub-block, k-chunk) pairs — the
    §3.2 telescoping applied to the FFN decode path. Bit for bit what
    :func:`bitmask_spmm` gives, on the card and in the plain versions' fp32
    within rounding.
    """
    return worklist_spmm(x, vals, wl, bk=bk, bn=bn, bm_rows=bm_rows)[0]
