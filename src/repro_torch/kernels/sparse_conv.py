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
blocks.

The lazy im2col (``im2col="lazy"``, ``layout="tap"`` packing, the compact
schedule; what ``im2col="auto"`` takes there) never builds the patch
matrix: in the tap layout a K-chunk is one ``(tap, channel group)`` slab of
the input map. On the CPU the plain version
:func:`worklist_spmm_slabs_plain` stacks only the live slabs
(:func:`extract_tap_slabs`) and walks them; on CUDA the walker reads each
live slab straight from the NHWC map (its tap-slab operand, im2col tensor
copies). Both compute the ``taps`` path's terms in its order, so the result
is bitwise the ``taps`` path's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bitmask as bm
from repro_torch.core.sparse import Padding, Stride, normalize_stride, \
    resolve_pads
from repro_torch.core.telescope import combine_schedule_requests
from repro_torch.kernels._cuda import CudaKernel, I, P, check_cuda_tensor, \
    ptr
from repro_torch.kernels.bitmask_spmm import subblock_macs
from repro_torch.kernels.grid import GridGeometry, check_lm_grid, \
    check_row_block, tap_geometry
from repro_torch.kernels.worklist_core import (DEFAULT_BM, LANE, WorkList,
                                               _occupancy_of, _tile_output,
                                               _worklist_spmm_cuda,
                                               activate, build_worklist,
                                               check_row_tiling,
                                               map_pixels_contiguous,
                                               schedule_counters,
                                               worklist_spmm,
                                               worklist_spmm_plain)
from repro_torch.obs import span

CONV_GRID = CudaKernel("conv_grid.cu", "conv_grid_spmm", [
    P, P, P, P, P, P, P,                 # x vals indices occ out occ cnt
    I, I, I, I, I, I, I, I, I,           # M K nb mb max_nz bk bn bm sub_m
    I, I, I, I, I,                       # two_sided relu emit_occ count
                                         # col_group
    P])                                  # stream

# columns of a dense-grid conv CTA (csrc/ffn_grid.cuh): the wider group,
# since a conv layer's rows give the grid CTAs enough
CONV_COL_GROUP = 32


def conv_grid_geometry(M: int, nb: int, *, bm_rows: int,
                       bn: int) -> GridGeometry:
    """The dense-grid conv's launch: 32-row x 32-column CTAs."""
    check_row_block(M, bm_rows)
    return GridGeometry(M=M, nb=nb, bm=bm_rows, bn=bn,
                        col_group=CONV_COL_GROUP,
                        groups=-(-bn // CONV_COL_GROUP))


# ---------------------------------------------------------------------------
# dense-grid predicated GEMM (the instrumented path)
# ---------------------------------------------------------------------------
def sparse_conv_spmm_plain(patches: torch.Tensor, indices: torch.Tensor,
                           vals: torch.Tensor, *, bk: int, bn: int,
                           bm_rows: int, sub_m: int, two_sided: bool,
                           fuse_relu: bool, emit_occupancy: bool,
                           count_macs: bool):
    """Plain version of the dense-grid kernel, on any device: the predicated
    grid of :func:`~repro_torch.kernels.bitmask_spmm.subblock_macs`, then
    the ReLU and occupancy epilogue."""
    nb = indices.shape[0]
    mb = patches.shape[0] // bm_rows
    acc, counts = subblock_macs(patches, indices, vals, bk=bk, bm=bm_rows,
                                sub_m=sub_m, two_sided=two_sided)
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
    # the tensor copies' 16-byte strides and alignment
    check_lm_grid(patches, [("vals", vals)], bk, bn)
    geom = conv_grid_geometry(M, nb, bm_rows=bm_rows, bn=bn)
    mb = M // bm_rows
    # scratch the kernel fills with the activation occupancy
    occ = torch.empty((M // sub_m, K // bk), dtype=torch.int32, device=dev)
    out = torch.empty((M, nb * bn), dtype=torch.float32, device=dev)
    occ_out = torch.empty((M // sub_m, nb), dtype=torch.int32, device=dev) \
        if emit_occupancy else None
    counts = torch.empty((nb, mb), dtype=torch.int32, device=dev) \
        if count_macs else None
    CONV_GRID.launch(dev, patches.data_ptr(), vals.data_ptr(),
                     indices.data_ptr(), occ.data_ptr(), out.data_ptr(),
                     ptr(occ_out), ptr(counts),
                     M, K, nb, mb, max_nz, bk, bn, bm_rows, sub_m,
                     int(two_sided), int(fuse_relu), int(emit_occupancy),
                     int(count_macs), geom.col_group)
    return (out,) + ((occ_out,) if emit_occupancy else ()) + \
        ((counts,) if count_macs else ())


def sparse_conv_spmm(patches: torch.Tensor, indices: torch.Tensor,
                     vals: torch.Tensor, *, bk: int = LANE, bn: int = LANE,
                     bm_rows: int = DEFAULT_BM, sub_m: Optional[int] = None,
                     two_sided: bool = True, fuse_relu: bool = True,
                     emit_occupancy: bool = False, count_macs: bool = False):
    """Dense-grid implicit-GEMM core: ``patches [M, K] @ W [K, N]`` + fused
    ReLU, with the in-lane ``sub_m``-row activation skip.

    A CUDA tensor launches ``csrc/conv_grid.cu``, which takes ``bm_rows``
    dividing or a multiple of 32, ``bk`` and ``bn`` multiples of 8
    (``bk <= 248``, ``bn <= 128``) and 16-byte-aligned operands, and raises
    ``ValueError`` otherwise; a CPU tensor runs
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


def extract_tap_slabs(x: torch.Tensor, kh: int, kw: int, stride: Stride,
                      padding: Padding, *, chunks, bk: int,
                      m_pad: int) -> torch.Tensor:
    """Lazy im2col: only the listed K-chunks of the tap-major patch matrix.

    In ``layout="tap"`` a K-chunk ``c = tap * (cin / bk) + sub`` is one
    shifted strided slice of the padded input (``(dy, dx) = divmod(tap,
    kw)``, channels ``sub * bk ..``). Returns ``[len(chunks), B * m_pad,
    bk]``, each image's rows zero-padded to ``m_pad``, equal value for value
    to those columns of :func:`extract_patches` (``strategy="taps"``).
    """
    b, _, _, cin = x.shape
    if cin % bk:
        raise ValueError(f"tap slabs need cin % bk == 0, got cin={cin} "
                         f"bk={bk}")
    cpt = cin // bk                               # chunks per tap
    xp, oh, ow, sh, sw = _padded_input(x, kh, kw, stride, padding)
    m_img = oh * ow
    slabs = []
    for c in np.asarray(chunks).tolist():
        tap, sub = divmod(int(c), cpt)
        dy, dx = divmod(tap, kw)
        s = xp[:, dy:dy + (oh - 1) * sh + 1:sh,
               dx:dx + (ow - 1) * sw + 1:sw, sub * bk:(sub + 1) * bk]
        slabs.append(s.reshape(b, m_img, bk))
    p = torch.stack(slabs, dim=0)                 # [L, b, m_img, bk]
    p = F.pad(p, (0, 0, 0, m_pad - m_img))
    return p.reshape(len(slabs), b * m_pad, bk)


def worklist_spmm_slabs_plain(x: torch.Tensor, vals: torch.Tensor,
                              wl: WorkList, *, kh: int, kw: int,
                              stride: Stride, padding: Padding, bk: int,
                              bn: int, bm_rows: int, sub_m: int, m_pad: int,
                              act: Optional[str], emit_occupancy: bool):
    """Plain version of the walker's tap-slab operand (the port of the
    reference's slab executor): the live slabs of the work list
    (:func:`extract_tap_slabs` of the union of its chunks), then the plain
    walker with ``wl.k`` remapped to the slabs' order. No live step: zeros
    and zero occupancy."""
    M = x.shape[0] * m_pad
    live = wl.k >= 0
    union = np.unique(wl.k[live])
    if union.size == 0:
        out = torch.zeros((M, wl.nb * bn), dtype=x.dtype, device=x.device)
        occ = torch.zeros((M // sub_m, wl.nb), dtype=torch.int32,
                          device=x.device)
        return (out, occ) if emit_occupancy else (out,)
    slot_of = np.zeros(int(union[-1]) + 1, np.int32)
    slot_of[union] = np.arange(union.size, dtype=np.int32)
    slabs = extract_tap_slabs(x, kh, kw, stride, padding, chunks=union,
                              bk=bk, m_pad=m_pad)          # [L, M, bk]
    flat = slabs.permute(1, 0, 2).reshape(M, union.size * bk)
    k = np.where(live, slot_of[np.maximum(wl.k, 0)], -1).astype(np.int32)
    wl_slabs = dataclasses.replace(wl, k=k, _combined={}, _device={},
                                   _live={})
    return worklist_spmm_plain(flat, vals, wl_slabs, bk=bk, bn=bn,
                               bm_rows=bm_rows, sub_m=sub_m, act=act,
                               emit_occupancy=emit_occupancy)


def worklist_spmm_slabs(x: torch.Tensor, vals: torch.Tensor, wl: WorkList,
                        *, kh: int, kw: int, stride: Stride,
                        padding: Padding, bk: int, bn: int, bm_rows: int,
                        sub_m: int, m_pad: int, act: Optional[str] = "relu",
                        emit_occupancy: bool = False):
    """The walker over the tap-major patch matrix of NHWC ``x`` without
    that matrix: ``wl``'s chunks are ``(tap, channel group)`` slabs of the
    map, each image ``m_pad`` rows. A CUDA tensor launches the walker's
    tap-slab operand (``csrc/walk.cu``: its tile mode reading the slabs
    from ``x`` with im2col tensor copies, or plain copies where
    :func:`~repro_torch.kernels.grid.walk_im2col_problem` finds them
    refused) or raises; a CPU tensor runs
    :func:`worklist_spmm_slabs_plain`. Returns ``(out [B * m_pad, nb * bn][,
    occupancy])`` as :func:`~repro_torch.kernels.worklist_core.
    worklist_spmm` does on the patch matrix."""
    geom = tap_geometry(x.shape, kh, kw, stride, padding, m_pad=m_pad)
    if m_pad % bm_rows or wl.mb * bm_rows != geom.rows:
        raise ValueError(f"a work list of {wl.mb} row blocks of {bm_rows} "
                         f"does not cover {geom.B} images of {m_pad} rows")
    kw_ = dict(bk=bk, bn=bn, bm_rows=bm_rows, sub_m=sub_m, act=act,
               emit_occupancy=emit_occupancy)
    if x.device.type == "cpu":
        return worklist_spmm_slabs_plain(x, vals, wl, kh=kh, kw=kw,
                                         stride=stride, padding=padding,
                                         m_pad=m_pad, **kw_)
    if x.device.type != "cuda":
        raise ValueError(f"no walker for device {x.device}")
    if emit_occupancy:
        check_row_tiling(bm_rows, sub_m)
    return _worklist_spmm_cuda(x, vals, None, wl, mb_per_img=m_pad // bm_rows,
                               ncolors=2, taps=geom, **kw_)


def shortcut_rows(s: torch.Tensor, m_pad: int, ld: int) -> torch.Tensor:
    """The shortcut map ``s`` [B, OH, OW, C] as the ``[B * m_pad, ld]``
    rows a conv's flush writes (each image ``m_pad`` rows, ``ld >= C``
    columns): the buffer ``s`` was cut from where it is one, as a layer's
    own output of that geometry is (its pad rows are that layer's, which
    only reach the pad rows of the sum); else a zero-padded copy."""
    b, oh, ow, c = s.shape
    m_img = oh * ow
    view = (ld == c and m_pad >= m_img
            and s.stride() == (m_pad * ld, ow * ld, ld, 1)
            and s.data_ptr() % 16 == 0
            and s.untyped_storage().nbytes() >= (s.storage_offset()
                                                 + b * m_pad * ld)
            * s.element_size())
    if view:
        return s.as_strided((b * m_pad, ld), (ld, 1))
    return F.pad(s.reshape(b, m_img, c),
                 (0, ld - c, 0, m_pad - m_img)).reshape(b * m_pad, ld)


def _static_worklist(w: bm.BlockSparseMatrix, mb: int, mb_per_img: int,
                     wl_cache: Optional[dict]):
    """The pack-time (weight-only) schedule for ``mb`` row blocks, cached
    in ``wl_cache`` per row-block count; a build is a
    ``conv.worklist_build`` span."""
    wl = wl_cache.get(mb) if wl_cache is not None else None
    if wl is None:
        if w.vals.is_cuda and torch.cuda.is_current_stream_capturing():
            raise ValueError("a layer's static work list is built on the "
                             "host: run one eager call before CUDA-graph "
                             "capture, so that capture finds it cached")
        with span("conv.worklist_build"):
            wl = build_worklist(  # lint: ignore[EAGER-GUARD] no jax Tracer here
                w.host_indices(), mb, mb_per_img=mb_per_img,
                shard_of=w.shard_of)
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
                       wl_cache: Optional[dict] = None,
                       residual: Optional[torch.Tensor] = None):
    """One conv layer through the sparse kernels: x [B, H, W, Cin] ->
    [B, OH, OW, Cout] (ReLU fused when ``fuse_relu``).

    ``residual`` [B, OH, OW, Cout] (a ResNet block's shortcut) is added to
    the conv's output before the ReLU, and the occupancy is that of the
    sum. The compact schedule adds it in K1's flush (fp32, its tile mode:
    ``tile_kernel_residual``), reading it as the output's own padded rows
    (:func:`shortcut_rows`); a layer with a shortcut reads the patch matrix
    (``lazy`` is demoted to ``taps``). The dense schedule adds it by torch
    after its launch.

    ``w`` packs the matrixized filters (K = Cin*kh*kw, N = Cout, both
    chunk-padded) in ``layout`` (``"channel"`` pairs with the
    ``patches``/``slices`` strategies, ``"tap"`` with ``taps``).
    ``schedule="compact"`` walks the telescoped work list (static pack-time
    lists, cached in ``wl_cache`` per row-block count, or intersected with
    the activation occupancy when ``compact_activations``);
    ``schedule="dense"`` is the instrumented dense grid (required for
    ``count_macs``, which switches to it).

    ``im2col="lazy"`` (``layout="tap"`` only, else ``ValueError``) reads the
    live tap slabs of ``x`` instead of the patch matrix
    (:func:`worklist_spmm_slabs`); it is demoted to ``"taps"`` under
    ``schedule="dense"`` and ``compact_activations``, which need the whole
    patch matrix. The result is bitwise the ``taps`` path's.
    ``im2col="auto"`` resolves by the packing: ``"lazy"`` at
    ``layout="tap"`` (so ``"taps"`` where lazy is demoted), ``"slices"`` at
    ``layout="channel"``. At ``layout="tap"``, ``"patches"`` and
    ``"slices"`` mean ``"taps"``; ``"taps"`` builds the patch matrix on any
    schedule.

    Returns ``(out, aux)``: ``aux`` carries ``occupancy`` (int32 [B,
    ceil(M_img/sub_m), n_blocks]) and ``mac_counts`` when asked, the patch
    geometry, and — for compact schedules or ``report_schedule`` — the
    ``schedule`` counters record.
    """
    if count_macs and schedule == "compact":
        schedule = "dense"
        report_schedule = True
    if layout == "tap":
        if im2col == "auto":
            im2col = "lazy"
        elif im2col in ("patches", "slices"):
            im2col = "taps"
    elif im2col in ("taps", "lazy"):
        raise ValueError(f"im2col={im2col!r} needs layout='tap' packing")
    elif im2col == "auto":
        im2col = "slices"
    lazy = im2col == "lazy"
    if lazy and (schedule != "compact" or compact_activations
                 or residual is not None):
        im2col, lazy = "taps", False
    b = x.shape[0]
    if lazy:
        oh, ow = conv_out_size(x.shape[1], x.shape[2], kh, kw, stride,
                               padding)
        flat = None
        if not map_pixels_contiguous(x):
            # the operand reads whole images of NHWC pixels (a layer's own
            # output, cut from its padded rows, already is one)
            x = x.contiguous()
    else:
        patches, (oh, ow) = extract_patches(x, kh, kw, stride, padding,
                                            strategy=im2col)
    m_img = oh * ow
    k_total = w.shape[0]
    pad_rows = (-m_img) % bm_rows
    m_pad = m_img + pad_rows
    if not lazy:
        pad_k = k_total - patches.shape[-1]
        if pad_k < 0:
            raise ValueError(f"patches have {patches.shape[-1]} features, "
                             f"the packed filters {k_total}")
        flat = F.pad(patches, (0, pad_k, 0, pad_rows)).reshape(b * m_pad,
                                                               k_total)
    mb = (b * m_pad) // bm_rows
    aux = {"m_img": m_img, "k_total": k_total, "oh": oh, "ow": ow}
    res2d = None
    if residual is not None:
        if tuple(residual.shape) != (b, oh, ow, cout):
            raise ValueError(f"the shortcut {tuple(residual.shape)} does not "
                             f"match the conv's output {(b, oh, ow, cout)}")
        res2d = shortcut_rows(residual, m_pad, w.n_blocks * w.bn)

    wl = None
    if schedule == "compact" or report_schedule:
        mpi = m_pad // bm_rows
        if compact_activations:
            if x.is_cuda and torch.cuda.is_current_stream_capturing():
                raise ValueError("an activation-compacted work list is "
                                 "built on the host from each batch: it "
                                 "cannot be captured in a CUDA graph")
            occ_blk = bm.chunk_occupancy(flat, bm_rows, w.bk).cpu().numpy()
            wl = build_worklist(  # lint: ignore[EAGER-GUARD] no jax Tracer
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

    if lazy:
        res = worklist_spmm_slabs(
            x, w.vals, wl, kh=kh, kw=kw, stride=stride, padding=padding,
            bk=w.bk, bn=w.bn, bm_rows=bm_rows, sub_m=sub_m, m_pad=m_pad,
            act="relu" if fuse_relu else None,
            emit_occupancy=emit_occupancy)
    elif schedule == "compact":
        res = worklist_spmm(
            flat, w.vals, wl, bk=w.bk, bn=w.bn, bm_rows=bm_rows, sub_m=sub_m,
            mb_per_img=m_pad // bm_rows, ncolors=2,
            act="relu" if fuse_relu else None, emit_occupancy=emit_occupancy,
            residual=res2d)
    elif schedule == "dense":
        res = sparse_conv_spmm(
            flat, w.indices, w.vals, bk=w.bk, bn=w.bn, bm_rows=bm_rows,
            sub_m=sub_m, two_sided=two_sided,
            fuse_relu=fuse_relu and res2d is None,
            emit_occupancy=emit_occupancy and res2d is None,
            count_macs=count_macs)
        if res2d is not None:
            summed = activate(res[0] + res2d, None,
                              "relu" if fuse_relu else None)
            res = _occupancy_of(summed, w.n_blocks, w.bn, sub_m,
                                emit_occupancy) + res[1:]
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
