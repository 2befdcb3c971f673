"""Implicit-GEMM two-sided sparse conv2d (port of ``repro.kernels.sparse_conv``).

A conv layer runs as the paper's matrix interface: activations become
im2col patch rows, tiled against the chunk-block-sparse packed filters.
Two schedules drive the layer:

* ``schedule="compact"`` (default) — the telescoped work list
  (:mod:`repro_torch.kernels.worklist_core`): only stored filter chunks
  (∩ the activation occupancy when ``compact_activations``) are scheduled,
  dead row blocks degenerate to one flush-only step. This is the serving
  path; on CUDA it runs the walker kernel (``csrc/walk.cu``).
* ``schedule="dense"`` — the instrumented dense grid ``(nb, mb, max_nz)``
  with the ``sub_m``-row activation skip and the executed-MAC counters
  (:func:`sparse_conv_spmm`); on CUDA it runs ``csrc/conv_grid.cu``.

Both fuse ReLU into the flush and can emit the next layer's ``sub_m``-row
occupancy. Images are stacked with their rows padded to whole ``bm_rows``
blocks. The lazy im2col (``im2col="lazy"``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import bitmask as bm
from repro_torch.core.sparse import Padding, Stride, normalize_stride, \
    resolve_pads
from repro_torch.core.telescope import combine_schedule_requests
from repro_torch.kernels._cuda import CudaKernel, I, KERNEL_ROW_SLICE, P, \
    check_cuda_tensor, ptr
from repro_torch.kernels.worklist_core import (DEFAULT_BM, LANE,
                                               _tile_output,
                                               activation_occupancy,
                                               build_worklist,
                                               check_row_tiling,
                                               schedule_counters,
                                               worklist_spmm)

CONV_GRID = CudaKernel("conv_grid.cu", "conv_grid_spmm", [
    P, P, P, P, P, P, P,                 # x vals indices occ out occ cnt
    I, I, I, I, I, I, I, I, I,           # M K nb mb max_nz bk bn bm sub_m
    I, I, I, I,                          # two_sided relu emit_occ count
    P])                                  # stream


# ---------------------------------------------------------------------------
# dense-grid predicated GEMM (the instrumented path)
# ---------------------------------------------------------------------------
def sparse_conv_spmm_plain(patches: torch.Tensor, indices: torch.Tensor,
                           vals: torch.Tensor, *, bk: int, bn: int,
                           bm_rows: int, sub_m: int, two_sided: bool,
                           fuse_relu: bool, emit_occupancy: bool,
                           count_macs: bool):
    """Plain version of the dense-grid kernel, on any device: for each slot
    ``j`` of every n-block, MAC the chunk ``indices[n, j]`` into all row
    blocks, with the ``sub_m``-row sub-blocks whose activation occupancy
    bit is clear masked out (and not counted) when ``two_sided``."""
    M, K = patches.shape
    nb, max_nz = indices.shape
    mb, kb, nsub = M // bm_rows, K // bk, bm_rows // sub_m
    x4 = patches.reshape(mb, bm_rows, kb, bk)
    occ3 = activation_occupancy(patches, sub_m, bk).bool() \
        .reshape(mb, nsub, kb)
    acc = torch.zeros((nb, mb, bm_rows, bn), dtype=patches.dtype,
                      device=patches.device)
    counts = torch.zeros((nb, mb), dtype=torch.int32, device=patches.device)
    for j in range(max_nz):
        k = indices[:, j].long()
        valid = k >= 0                                       # [nb]
        ks = k.clamp_min(0)
        xg = x4[:, :, ks, :].permute(2, 0, 1, 3)             # [nb, mb, bm, bk]
        if two_sided:
            live = occ3[:, :, ks].permute(2, 0, 1) & valid[:, None, None]
            rows = live.repeat_interleave(sub_m, dim=2)      # [nb, mb, bm]
            counts += live.sum(-1, dtype=torch.int32)
        else:
            rows = valid[:, None, None].expand(nb, mb, bm_rows)
            counts += valid[:, None].to(torch.int32)
        acc += torch.matmul(xg * rows[..., None].to(xg.dtype),
                            vals[:, j][:, None])
    if fuse_relu:
        acc = torch.clamp_min(acc, 0.0)
    res = _tile_output(acc.reshape(nb * mb, bm_rows, bn), nb, mb, bm_rows,
                       bn, sub_m, emit_occupancy)
    return res + ((counts,) if count_macs else ())


def _sparse_conv_spmm_cuda(patches, indices, vals, *, bk, bn, bm_rows, sub_m,
                           two_sided, fuse_relu, emit_occupancy, count_macs):
    M, K = patches.shape
    dev = patches.device
    check_cuda_tensor("patches", patches, torch.float32, dev)
    check_cuda_tensor("indices", indices, torch.int32, dev)
    check_cuda_tensor("vals", vals, torch.float32, dev)
    nb, max_nz = indices.shape
    if tuple(vals.shape) != (nb, max_nz, bk, bn):
        raise ValueError(f"vals {tuple(vals.shape)} does not match indices "
                         f"({nb}, {max_nz}) and tile ({bk}, {bn})")
    if bn > 128:
        raise ValueError(f"the dense-grid kernel takes bn <= 128, got {bn}")
    check_row_tiling(bm_rows, sub_m)
    mb = M // bm_rows
    occ = activation_occupancy(patches, sub_m, bk)
    out = torch.empty((M, nb * bn), dtype=torch.float32, device=dev)
    occ_out = torch.empty((M // sub_m, nb), dtype=torch.int32, device=dev) \
        if emit_occupancy else None
    slices = -(-bm_rows // KERNEL_ROW_SLICE)
    partial = torch.empty((nb * mb, slices), dtype=torch.int32, device=dev) \
        if count_macs else None
    CONV_GRID.launch(dev, patches.data_ptr(), vals.data_ptr(),
                     indices.data_ptr(), occ.data_ptr(), out.data_ptr(),
                     ptr(occ_out), ptr(partial),
                     M, K, nb, mb, max_nz, bk, bn, bm_rows, sub_m,
                     int(two_sided), int(fuse_relu), int(emit_occupancy),
                     int(count_macs))
    res = (out,) + ((occ_out,) if emit_occupancy else ())
    if count_macs:
        res += (partial.sum(1, dtype=torch.int32).reshape(nb, mb),)
    return res


def sparse_conv_spmm(patches: torch.Tensor, indices: torch.Tensor,
                     vals: torch.Tensor, *, bk: int = LANE, bn: int = LANE,
                     bm_rows: int = DEFAULT_BM, sub_m: Optional[int] = None,
                     two_sided: bool = True, fuse_relu: bool = True,
                     emit_occupancy: bool = False, count_macs: bool = False):
    """Dense-grid implicit-GEMM core: ``patches [M, K] @ W [K, N]`` + fused
    ReLU, with the in-lane ``sub_m``-row activation skip.

    A CUDA tensor launches ``csrc/conv_grid.cu``; a CPU tensor runs
    :func:`sparse_conv_spmm_plain`. Returns ``out [M, N]``, plus the int32
    ``[M // sub_m, nb]`` occupancy when ``emit_occupancy`` and the int32
    ``[nb, M // bm_rows]`` executed-MAC counts when ``count_macs`` (sub-block
    MACs two-sided, whole-tile MACs one-sided), in that order.
    """
    M, K = patches.shape
    sub_m = bm_rows if sub_m is None else sub_m
    if M % bm_rows or K % bk or bm_rows % sub_m:
        raise ValueError(f"patches [{M}, {K}] do not tile by bm_rows="
                         f"{bm_rows}, bk={bk}, sub_m={sub_m}")
    kw = dict(bk=bk, bn=bn, bm_rows=bm_rows, sub_m=sub_m,
              two_sided=two_sided, fuse_relu=fuse_relu,
              emit_occupancy=emit_occupancy, count_macs=count_macs)
    if patches.device.type == "cpu":
        return sparse_conv_spmm_plain(patches, indices, vals, **kw)
    if patches.device.type != "cuda":
        raise ValueError(f"no dense-grid kernel for device {patches.device}")
    return _sparse_conv_spmm_cuda(patches, indices, vals, **kw)


# ---------------------------------------------------------------------------
# im2col and the layer entry point
# ---------------------------------------------------------------------------
def _padded_input(x: torch.Tensor, kh: int, kw: int, stride: Stride,
                  padding: Padding
                  ) -> Tuple[torch.Tensor, int, int, int, int]:
    """Zero-pad NHWC ``x`` for the conv window; returns (xp, oh, ow, sh, sw)."""
    sh, sw = normalize_stride(stride)
    (ph0, ph1), (pw0, pw1) = resolve_pads(tuple(x.shape[1:3]), kh, kw,
                                          stride, padding)
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    return xp, oh, ow, sh, sw


def conv_out_size(H: int, W: int, kh: int, kw: int, stride: Stride,
                  padding: Padding) -> Tuple[int, int]:
    """(OH, OW) for the layer geometry — host arithmetic only."""
    sh, sw = normalize_stride(stride)
    (ph0, ph1), (pw0, pw1) = resolve_pads((H, W), kh, kw, stride, padding)
    return (H + ph0 + ph1 - kh) // sh + 1, (W + pw0 + pw1 - kw) // sw + 1


def extract_patches(x: torch.Tensor, kh: int, kw: int, stride: Stride,
                    padding: Padding, *, strategy: str = "auto"
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """im2col rows for the implicit GEMM: [B, OH*OW, Cin*kh*kw] (+ (OH, OW)).

    * ``"patches"`` — ``F.unfold`` on the padded NCHW map; channel-major
      feature order (cin, kh, kw), matching ``layout="channel"`` packing.
    * ``"slices"``  — kh*kw strided slices of the padded map, stacked and
      transposed to the same channel-major order.
    * ``"taps"``    — the same slices without the transpose: tap-major
      order (kh, kw, cin), matching ``layout="tap"`` packing.
    * ``"auto"``    — ``"slices"``.
    """
    if strategy == "auto":
        strategy = "slices"
    if strategy not in ("patches", "slices", "taps"):
        raise ValueError(f"unknown im2col strategy {strategy!r}")
    b, _, _, cin = x.shape
    xp, oh, ow, sh, sw = _padded_input(x, kh, kw, stride, padding)
    if strategy == "patches":
        cols = F.unfold(xp.permute(0, 3, 1, 2), (kh, kw), stride=(sh, sw))
        return cols.transpose(1, 2).reshape(b, oh * ow, cin * kh * kw), \
            (oh, ow)
    parts = [xp[:, dy:dy + (oh - 1) * sh + 1:sh,
                dx:dx + (ow - 1) * sw + 1:sw, :]
             for dy in range(kh) for dx in range(kw)]
    p = torch.stack(parts, dim=3)                 # [b, oh, ow, kh*kw, cin]
    if strategy == "slices":
        p = p.transpose(3, 4)                     # channel-major features
    return p.reshape(b, oh * ow, cin * kh * kw), (oh, ow)


def _static_worklist(w: bm.BlockSparseMatrix, mb: int, mb_per_img: int,
                     wl_cache: Optional[dict]):
    """The pack-time (weight-only) schedule for ``mb`` row blocks, cached
    in ``wl_cache`` per row-block count."""
    wl = wl_cache.get(mb) if wl_cache is not None else None
    if wl is None:
        wl = build_worklist(  # lint: ignore[EAGER-GUARD] torch is eager
            w.host_indices(), mb, mb_per_img=mb_per_img, shard_of=w.shard_of)
        if wl_cache is not None:
            wl_cache[mb] = wl
    return wl


def sparse_conv2d_nhwc(x: torch.Tensor, w: bm.BlockSparseMatrix, kh: int,
                       kw: int, cout: int, *, stride: Stride = 1,
                       padding: Padding = "SAME", sub_m: int = 8,
                       two_sided: bool = True, fuse_relu: bool = True,
                       emit_occupancy: bool = False,
                       count_macs: bool = False,
                       bm_rows: int = DEFAULT_BM,
                       schedule: str = "compact",
                       im2col: str = "auto",
                       layout: str = "channel",
                       compact_activations: bool = False,
                       report_schedule: bool = False,
                       wl_cache: Optional[dict] = None):
    """One conv layer through the sparse kernels: x [B, H, W, Cin] ->
    [B, OH, OW, Cout] (ReLU fused when ``fuse_relu``).

    ``w`` packs the matrixized filters (K = Cin*kh*kw, N = Cout, both
    chunk-padded) in ``layout`` (``"channel"`` pairs with the
    ``patches``/``slices`` strategies, ``"tap"`` with ``taps``).
    ``schedule="compact"`` walks the telescoped work list (static pack-time
    lists, cached in ``wl_cache`` per row-block count, or intersected with
    the activation occupancy when ``compact_activations``);
    ``schedule="dense"`` is the instrumented dense grid (required for
    ``count_macs``, which switches to it).

    Returns ``(out, aux)``: ``aux`` carries ``occupancy`` (int32 [B,
    ceil(M_img/sub_m), n_blocks]) and ``mac_counts`` when asked, the patch
    geometry, and — for compact schedules or ``report_schedule`` — the
    ``schedule`` counters record.
    """
    if count_macs and schedule == "compact":
        schedule = "dense"
        report_schedule = True
    if im2col == "lazy":
        raise NotImplementedError("im2col='lazy' is not ported yet")
    if layout == "tap":
        if im2col in ("auto", "patches", "slices"):
            im2col = "taps"
    elif im2col == "taps":
        raise ValueError("im2col='taps' needs layout='tap' packing")
    b = x.shape[0]
    patches, (oh, ow) = extract_patches(x, kh, kw, stride, padding,
                                        strategy=im2col)
    m_img = oh * ow
    k_total = w.shape[0]
    pad_rows = (-m_img) % bm_rows
    m_pad = m_img + pad_rows
    pad_k = k_total - patches.shape[-1]
    if pad_k < 0:
        raise ValueError(f"patches have {patches.shape[-1]} features, the "
                         f"packed filters {k_total}")
    flat = F.pad(patches, (0, pad_k, 0, pad_rows)).reshape(b * m_pad,
                                                           k_total)
    mb = (b * m_pad) // bm_rows
    aux = {"m_img": m_img, "k_total": k_total, "oh": oh, "ow": ow}

    wl = None
    if schedule == "compact" or report_schedule:
        mpi = m_pad // bm_rows
        if compact_activations:
            occ_blk = bm.chunk_occupancy(flat, bm_rows, w.bk).cpu().numpy()
            wl = build_worklist(  # lint: ignore[EAGER-GUARD] torch is eager
                w.host_indices(), mb, occ_blk=occ_blk, mb_per_img=mpi,
                shard_of=w.shard_of)
        else:
            wl = _static_worklist(w, mb, mpi, wl_cache)
        aux["schedule"] = dict(schedule_counters(wl),
                               activation_compacted=compact_activations)
        if report_schedule:
            # a fetch stays outstanding for ~one pair's sweep
            aux["schedule"]["combining"] = combine_schedule_requests(
                wl.k, fetch_latency=wl.num_steps / max(wl.num_pairs, 1))
            cs = wl.combined()
            aux["schedule"]["cross_request"] = {
                "requests": cs.requests,
                "per_image_fetches": cs.per_image_fetches,
                "fetches": cs.num_fetches,
                "images": cs.images,
                "combine_factor": cs.cross_request_combine_factor,
            }
            # what the static schedule runs for this geometry
            static = _static_worklist(w, mb, mpi, wl_cache) \
                if compact_activations else wl
            aux["schedule"]["static_scheduled_steps"] = static.num_steps

    if schedule == "compact":
        res = worklist_spmm(
            flat, w.vals, wl, bk=w.bk, bn=w.bn, bm_rows=bm_rows, sub_m=sub_m,
            mb_per_img=m_pad // bm_rows, ncolors=2,
            act="relu" if fuse_relu else None, emit_occupancy=emit_occupancy)
    elif schedule == "dense":
        res = sparse_conv_spmm(
            flat, w.indices, w.vals, bk=w.bk, bn=w.bn, bm_rows=bm_rows,
            sub_m=sub_m, two_sided=two_sided, fuse_relu=fuse_relu,
            emit_occupancy=emit_occupancy, count_macs=count_macs)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    out = res[0].reshape(b, m_pad, w.n_blocks * w.bn)
    out = out[:, :m_img, :cout].reshape(b, oh, ow, cout)
    i = 1
    if emit_occupancy:
        occ = res[i].reshape(b, m_pad // sub_m, w.n_blocks)
        aux["occupancy"] = occ[:, : -(-m_img // sub_m)]
        i += 1
    if count_macs:
        aux["mac_counts"] = res[i]
    return out, aux
