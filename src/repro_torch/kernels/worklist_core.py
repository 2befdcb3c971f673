"""Work-list sparse GEMM core (BARISTA §3.2 telescoped scheduling).

Port of ``repro.kernels.worklist_core`` for the single-stream conv path:

1. :func:`build_worklist` + :class:`WorkList` — compact a packed weight
   chunk table (optionally ∩ the activation-chunk occupancy) into per-pair
   slot lists and their flat pair-major serialization. Pure host numpy,
   array-equal to the reference.
2. :func:`worklist_spmm` — run the schedule. On a CUDA tensor it launches
   the hand-written walker (``csrc/walk.cu``); on a CPU tensor it runs the
   plain version :func:`worklist_spmm_plain` (gather the scheduled tile
   pairs, one batched matmul, ``index_add_`` per (n, m) pair in schedule
   order, epilogue) — the port of the reference's XLA executor.
3. :func:`schedule_stats` — the tensor model of the step counts
   :func:`build_worklist` schedules, and :func:`schedule_counters`, the
   record both engines report.

The gated two-stream walk (``gate_indices`` / ``vals2``) belongs to the LM
FFN path and is not ported yet: :func:`build_worklist` still builds the
two-stream schedule on the host, but the executors take one stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._cuda import CudaKernel, I, KERNEL_ROW_SLICE, P, \
    check_cuda_tensor, ptr

DEFAULT_BM = 128
LANE = 128

# committed cluster-balance bound: per-device scheduled-step counts of a
# mesh-sharded work list stay within this fraction of the mean
SHARD_BALANCE_TOL = 0.10

WALK = CudaKernel("walk.cu", "walk_spmm", [
    P, P, P, P, P, P, P,                 # x vals pair_ptr k j out occ
    I, I, I, I, I, I, I, I, I,           # M K nb mb max_nz bk bn bm sub_m
    I, I, I, I,                          # relu emit_occ ncolors mb_per_img
    P])                                  # stream


# ---------------------------------------------------------------------------
# activation epilogue and occupancy
# ---------------------------------------------------------------------------
def activate(h: torch.Tensor, g: Optional[torch.Tensor],
             act: Optional[str]) -> torch.Tensor:
    """fp32 activation at the accumulator flush (``None`` = identity).
    GELU is the tanh approximation, as ``jax.nn.gelu`` defaults to."""
    if act is None:
        return h
    if act == "relu":
        return torch.clamp_min(h, 0.0)
    if act == "relu2":
        r = torch.clamp_min(h, 0.0)
        return r * r
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "swiglu":
        return F.silu(g) * h
    if act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    raise ValueError(act)


def activation_occupancy(x: torch.Tensor, sub_m: int, bk: int) -> torch.Tensor:
    """int32 [M // sub_m, K // bk] tile-occupancy of ``x`` at ``sub_m``-row
    granularity (the activation-side skip predicate)."""
    M, K = x.shape
    return (x.reshape(M // sub_m, sub_m, K // bk, bk) != 0).any(dim=3) \
        .any(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Telescoped work-list compaction (host numpy)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CombinedSchedule:
    """Cross-request telescoped fetch plan for one batched schedule: one
    fetch per distinct (stream, n_block, chunk) per batch, in schedule
    order; ``per_image_fetches`` is the per-image dedup baseline."""

    fetch_stream: np.ndarray          # [F] int32 (0 = k, 1 = k2/gate)
    fetch_n: np.ndarray               # [F] int32 n_block
    fetch_k: np.ndarray               # [F] int32 weight k-chunk id
    fetch_at: np.ndarray              # [F] int64 issuing flat step
    mb_per_img: int
    images: int
    requests: int
    per_image_fetches: int

    @property
    def num_fetches(self) -> int:
        return int(self.fetch_n.shape[0])

    @property
    def cross_request_combine_factor(self) -> float:
        return self.per_image_fetches / max(self.num_fetches, 1)

    @property
    def combine_factor(self) -> float:
        return self.requests / max(self.num_fetches, 1)


def _build_combined(wl: "WorkList", mpi: int) -> CombinedSchedule:
    """Dedup the flat schedule's per-step chunk reads batch-wide and count
    the per-image baseline (host numpy over the flat arrays)."""
    if wl.mb % mpi:
        raise ValueError(f"mb_per_img={mpi} does not divide mb={wl.mb}")
    images = wl.mb // mpi
    streams: Tuple[Tuple[int, np.ndarray], ...] = ((0, wl.k),)
    if wl.k2 is not None:
        streams = streams + ((1, wl.k2),)
    f_stream, f_n, f_k, f_at = [], [], [], []
    requests = 0
    per_image = 0
    for sid, ks in streams:
        live = np.nonzero(ks >= 0)[0]
        if live.size == 0:
            continue
        n64 = wl.n[live].astype(np.int64)
        k64 = ks[live].astype(np.int64)
        kmax = int(k64.max()) + 1
        key = n64 * kmax + k64
        # return_index is the first occurrence: `live` is in schedule order
        _, first_idx = np.unique(key, return_index=True)
        f_stream.append(np.full(first_idx.size, sid, np.int32))
        f_n.append(wl.n[live][first_idx])
        f_k.append(ks[live][first_idx])
        f_at.append(live[first_idx].astype(np.int64))
        requests += int(live.size)
        img = (wl.m[live] // mpi).astype(np.int64)
        per_image += int(np.unique(img * (wl.nb * kmax) + key).size)
    if f_n:
        stream = np.concatenate(f_stream)
        n_arr = np.concatenate(f_n)
        k_arr = np.concatenate(f_k)
        at = np.concatenate(f_at)
        order = np.argsort(at, kind="stable")
        stream, n_arr, k_arr, at = (stream[order], n_arr[order],
                                    k_arr[order], at[order])
    else:
        stream = n_arr = k_arr = np.zeros((0,), np.int32)
        at = np.zeros((0,), np.int64)
    return CombinedSchedule(stream, n_arr, k_arr, at, mpi, images,
                            requests, per_image)


@dataclasses.dataclass
class DeviceSchedule:
    """What the walker kernel reads of a work list, on one device, built
    once and reused by every call: ``pair_ptr`` [nb*mb + 1] segment offsets
    and ``k``/``j`` [T], all int32."""

    pair_ptr: torch.Tensor
    k: torch.Tensor
    j: torch.Tensor


@dataclasses.dataclass
class WorkList:
    """Compacted schedule for a chunk-block-sparse matmul grid.

    Per ``(n_block, m_block)`` pair, the stored filter chunk list ∩ the
    activation occupancy, in two forms: ``ragged_idx [nb, mb, max_live]`` +
    ``steps_per_pair [nb, mb]``, and the flat pair-major arrays
    ``n/m/k/j/first/last [num_steps]``. A pair with no live work is one
    flush-only step (``k == j == -1``) so its block is still written.
    ``k2`` is the optional second (gate) stream; ``mb_per_img`` the row
    blocks of one image in a batched schedule; ``shard_of`` the cluster
    assignment of the n-blocks.
    """

    n: np.ndarray
    m: np.ndarray
    k: np.ndarray
    j: np.ndarray
    first: np.ndarray
    last: np.ndarray
    ragged_idx: np.ndarray
    steps_per_pair: np.ndarray
    nb: int
    mb: int
    max_nz: int
    k2: Optional[np.ndarray] = None
    mb_per_img: Optional[int] = None
    shard_of: Optional[np.ndarray] = None
    _combined: Dict[int, CombinedSchedule] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _device: Dict[str, DeviceSchedule] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _live: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def num_steps(self) -> int:
        return int(self.n.shape[0])

    @property
    def num_pairs(self) -> int:
        return self.nb * self.mb

    @property
    def live_mask(self) -> np.ndarray:
        live = self.k >= 0
        if self.k2 is not None:
            live = live | (self.k2 >= 0)
        return live

    @property
    def mac_steps(self) -> int:
        return int(self.live_mask.sum())

    @property
    def flush_only_steps(self) -> int:
        return self.num_steps - self.mac_steps

    @property
    def dense_grid_steps(self) -> int:
        return self.nb * self.mb * self.max_nz

    def pair_ptr(self) -> np.ndarray:
        """int32 [nb*mb + 1] CSR offsets of each pair's segment."""
        counts = np.maximum(self.steps_per_pair.reshape(-1), 1)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def on_device(self, device) -> DeviceSchedule:
        """The walker's arrays on ``device`` (copied once, then cached)."""
        key = str(torch.device(device))
        ds = self._device.get(key)
        if ds is None:
            ds = DeviceSchedule(*(
                torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                device=device)
                for a in (self.pair_ptr(), self.k, self.j)))
            self._device[key] = ds
        return ds

    def live_steps(self, device) -> Tuple[torch.Tensor, ...]:
        """``(n, m, k, j)`` int64 of the live steps on ``device``, for the
        plain version (copied at its first call there, then cached)."""
        key = str(torch.device(device))
        live = self._live.get(key)
        if live is None:
            sel = self.k >= 0
            live = tuple(torch.as_tensor(a[sel], dtype=torch.int64,
                                         device=device)
                         for a in (self.n, self.m, self.k, self.j))
            self._live[key] = live
        return live

    def combined(self, mb_per_img: Optional[int] = None) -> CombinedSchedule:
        """The cross-request fetch plan (cached per image granularity)."""
        mpi = mb_per_img if mb_per_img is not None else self.mb_per_img
        mpi = self.mb if mpi is None else mpi
        cs = self._combined.get(mpi)
        if cs is None:
            cs = _build_combined(self, mpi)
            self._combined[mpi] = cs
        return cs


def _live_map(indices: np.ndarray, mb: int,
              occ_blk: Optional[np.ndarray]) -> np.ndarray:
    """live[n, m, j] = stored chunk j of n-block ∧ activation block
    (m, chunk) occupied (all occupied when ``occ_blk`` is None)."""
    nb, max_nz = indices.shape
    valid = indices >= 0
    if occ_blk is None:
        return np.broadcast_to(valid[:, None, :], (nb, mb, max_nz))
    occ_blk = np.asarray(occ_blk, bool)
    if occ_blk.shape[0] != mb:
        raise ValueError(f"occ_blk has {occ_blk.shape[0]} row blocks, "
                         f"expected {mb}")
    safe = np.where(valid, indices, 0)
    return valid[:, None, :] & occ_blk[:, safe].transpose(1, 0, 2)


def build_worklist(indices: np.ndarray, mb: int, *,
                   occ_blk: Optional[np.ndarray] = None,
                   gate_indices: Optional[np.ndarray] = None,
                   mb_per_img: Optional[int] = None,
                   shard_of: Optional[np.ndarray] = None) -> WorkList:
    """Compact a [nb, max_nz] chunk index table into a :class:`WorkList`.

    ``occ_blk`` (optional bool [mb, kb]) intersects the lists with the
    activation occupancy (two-sided compaction, data-dependent).
    ``gate_indices`` adds a second weight stream (union of live sets).
    ``mb_per_img`` and ``shard_of`` are recorded for the fetch plan and the
    per-device step counters.
    """
    indices = np.asarray(indices)
    if mb_per_img is not None and mb % mb_per_img:
        raise ValueError(f"mb_per_img={mb_per_img} does not divide mb={mb}")
    nb, max_nz = indices.shape
    if shard_of is not None:
        shard_of = np.asarray(shard_of, np.int32)
        if shard_of.shape != (nb,):
            raise ValueError(f"shard_of shape {shard_of.shape} != ({nb},)")
    live1 = _live_map(indices, mb, occ_blk)
    if gate_indices is None:
        live = live1
    else:
        gate_indices = np.asarray(gate_indices)
        if gate_indices.shape != indices.shape:
            raise ValueError(f"gate_indices {gate_indices.shape} != "
                             f"indices {indices.shape}")
        live2 = _live_map(gate_indices, mb, occ_blk)
        live = live1 | live2
    steps = live.sum(-1).astype(np.int64)                    # [nb, mb]
    max_live = max(int(steps.max(initial=0)), 1)
    order = np.argsort(~live, axis=-1, kind="stable")
    ragged = np.where(np.arange(max_nz)[None, None, :] < steps[..., None],
                      order, -1)[..., :max_live].astype(np.int32)
    counts = np.maximum(steps, 1).reshape(-1)                # [nb*mb]
    total = int(counts.sum())
    pair = np.repeat(np.arange(nb * mb), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(total) - starts[pair]
    n_arr = (pair // mb).astype(np.int32)
    m_arr = (pair % mb).astype(np.int32)
    j_arr = ragged.reshape(nb * mb, max_live)[
        pair, np.minimum(pos, max_live - 1)]
    j_clip = np.maximum(j_arr, 0)

    def stream_k(idx, lv):
        hit = (j_arr >= 0) & lv[n_arr, m_arr, j_clip]
        return np.where(hit, idx[n_arr, j_clip], -1).astype(np.int32)

    k_arr = stream_k(indices, live1)
    k2_arr = stream_k(gate_indices, live2) if gate_indices is not None \
        else None
    first = (pos == 0).astype(np.int32)
    last = (pos == counts[pair] - 1).astype(np.int32)
    return WorkList(n_arr, m_arr, k_arr, j_arr.astype(np.int32), first,
                    last, ragged, steps.astype(np.int32), nb, mb, max_nz,
                    k2=k2_arr, mb_per_img=mb_per_img, shard_of=shard_of)


# ---------------------------------------------------------------------------
# per-shard schedule accounting
# ---------------------------------------------------------------------------
def per_shard_steps(wl: WorkList,
                    num_shards: Optional[int] = None) -> np.ndarray:
    """Scheduled steps per device of a sharded work list (live MACs plus
    one flush-only step per dead pair of the device's n-blocks)."""
    if wl.shard_of is None:
        raise ValueError("work list carries no shard assignment "
                         "(build_worklist(..., shard_of=...))")
    d = num_shards if num_shards is not None \
        else int(wl.shard_of.max(initial=0)) + 1
    per_pair = np.maximum(np.asarray(wl.steps_per_pair, np.int64), 1)
    return np.bincount(wl.shard_of, weights=per_pair.sum(axis=1),
                       minlength=d).astype(np.int64)


def shard_imbalance(counts: np.ndarray) -> float:
    """max/mean - 1 of the per-device step counts (0.0 = perfect)."""
    counts = np.asarray(counts, np.float64)
    if counts.size <= 1 or counts.sum() == 0:
        return 0.0
    return float(counts.max() / counts.mean() - 1.0)


def shard_scaling_efficiency(counts: np.ndarray) -> float:
    """``total / (D * max)`` of the per-device step counts (1.0 = even)."""
    counts = np.asarray(counts, np.float64)
    if counts.size == 0 or counts.max() == 0:
        return 1.0
    return float(counts.sum() / (counts.size * counts.max()))


# ---------------------------------------------------------------------------
# tensor schedule model (no kernel)
# ---------------------------------------------------------------------------
def schedule_stats(patches: Optional[torch.Tensor], indices: torch.Tensor, *,
                   bk: int, bm_rows: int = DEFAULT_BM,
                   occ: Optional[torch.Tensor] = None,
                   mb: Optional[int] = None,
                   gate_indices: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Model of the work-list step counts: ``live_chunk_steps`` (stored
    chunk ∧ occupied block), ``dead_pairs``, ``scheduled_steps`` (live +
    one flush-only step per dead pair) and ``dense_grid_steps``. Takes the
    patch matrix, or its block occupancy ``occ`` [mb, kb], or just ``mb``
    for the static pack-time schedule."""
    indices = torch.as_tensor(indices)
    dev = indices.device
    if patches is not None:
        M, K = patches.shape
        mb, kb = M // bm_rows, K // bk
        occ = (patches.reshape(mb, bm_rows, kb, bk) != 0).any(dim=3) \
            .any(dim=1)
    elif occ is not None:
        occ = torch.as_tensor(occ, device=dev).bool()
        mb, kb = occ.shape
    else:
        if mb is None:
            raise ValueError("need patches, occ, or mb")
        kb = int(indices.max()) + 1 if indices.numel() else 1
        occ = torch.ones((mb, max(kb, 1)), dtype=torch.bool, device=dev)

    def live_of(idx):
        valid = idx >= 0
        safe = torch.where(valid, idx, 0).long()
        return valid[:, None, :] & occ[:, safe].permute(1, 0, 2)

    live = live_of(indices)                                  # [nb, mb, nz]
    if gate_indices is not None:
        live = live | live_of(torch.as_tensor(gate_indices, device=dev))
    nb, max_nz = indices.shape
    live_steps = live.sum()
    dead_pairs = (live.sum(-1) == 0).sum()
    return {"live_chunk_steps": live_steps,
            "dead_pairs": dead_pairs,
            "scheduled_steps": live_steps + dead_pairs,
            "dense_grid_steps": torch.tensor(nb * mb * max_nz)}


def schedule_counters(wl: WorkList, *,
                      predicated_steps: Optional[int] = None,
                      combine: bool = False,
                      mb_per_img: Optional[int] = None,
                      mesh: bool = False,
                      num_shards: Optional[int] = None) -> Dict[str, float]:
    """The unified schedule-counters record both serving layers report
    (see ``repro.kernels.worklist_core.schedule_counters``)."""
    rec = {"scheduled_steps": wl.num_steps,
           "live_chunk_steps": wl.mac_steps,
           "flush_only_steps": wl.flush_only_steps,
           "dense_grid_steps": wl.dense_grid_steps}
    if predicated_steps is not None:
        rec["predicated_grid_steps"] = int(predicated_steps)
        rec["compaction_factor"] = predicated_steps / max(wl.num_steps, 1)
    if combine:
        cs = wl.combined(mb_per_img)
        rec["filter_chunk_requests"] = cs.requests
        rec["per_image_filter_fetches"] = cs.per_image_fetches
        rec["combined_filter_fetches"] = cs.num_fetches
        rec["images"] = cs.images
        rec["cross_request_combine_factor"] = \
            cs.cross_request_combine_factor
    if mesh:
        counts = per_shard_steps(wl, num_shards)
        rec["num_devices"] = int(counts.size)
        rec["per_device_steps"] = [int(c) for c in counts]
        rec["step_imbalance"] = shard_imbalance(counts)
        rec["step_scaling_efficiency"] = shard_scaling_efficiency(counts)
    return rec


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------
def check_row_tiling(bm_rows: int, sub_m: int) -> None:
    """Both conv kernels cut a row block into 64-row slices and emit
    occupancy (and skip, in the dense grid) per ``sub_m`` rows inside one
    slice."""
    if bm_rows % sub_m or KERNEL_ROW_SLICE % sub_m:
        raise ValueError(f"sub_m={sub_m} must divide bm_rows={bm_rows} and "
                         f"{KERNEL_ROW_SLICE}")


def _tile_output(acc: torch.Tensor, nb: int, mb: int, bm_rows: int, bn: int,
                 sub_m: int, emit_occupancy: bool):
    """[nb*mb, bm, bn] pair accumulators -> ``(out [M, nb*bn][, occ])``."""
    M = mb * bm_rows
    out = acc.reshape(nb, mb, bm_rows, bn).permute(1, 2, 0, 3) \
             .reshape(M, nb * bn)
    if not emit_occupancy:
        return (out,)
    occ = (out.reshape(M // sub_m, sub_m, nb, bn) != 0).any(dim=3) \
        .any(dim=1).to(torch.int32)
    return (out, occ)


def worklist_spmm_plain(patches: torch.Tensor, vals: torch.Tensor,
                        wl: WorkList, *, bk: int, bn: int, bm_rows: int,
                        sub_m: int, act: Optional[str],
                        emit_occupancy: bool):
    """Plain version of the walker, on any device: gather exactly the
    scheduled (x block, W chunk) tile pairs, one batched matmul,
    ``index_add_`` of the products per (n, m) pair in schedule order (a
    sequential loop on the CPU, so the order is ascending j; atomic and
    unordered on CUDA), then the epilogue. Flush-only steps cost nothing:
    pairs without products stay zero."""
    M, K = patches.shape
    mb, kb = M // bm_rows, K // bk
    ln, lm, lk, lj = wl.live_steps(patches.device)
    x4 = patches.reshape(mb, bm_rows, kb, bk)
    xg = x4[lm, :, lk, :]                                    # [T, bm, bk]
    wg = vals[ln, lj]                                        # [T, bk, bn]
    prod = torch.bmm(xg, wg)                                 # [T, bm, bn]
    acc = torch.zeros((wl.nb * mb, bm_rows, bn), dtype=patches.dtype,
                      device=patches.device)
    acc.index_add_(0, ln * mb + lm, prod)
    acc = activate(acc, None, act)
    return _tile_output(acc, wl.nb, mb, bm_rows, bn, sub_m, emit_occupancy)


def _worklist_spmm_cuda(patches, vals, wl, *, bk, bn, bm_rows, sub_m,
                        mb_per_img, ncolors, relu, emit_occupancy):
    M, K = patches.shape
    dev = patches.device
    check_cuda_tensor("patches", patches, torch.float32, dev)
    check_cuda_tensor("vals", vals, torch.float32, dev)
    nb, max_nz = vals.shape[:2]
    if tuple(vals.shape) != (wl.nb, wl.max_nz, bk, bn):
        raise ValueError(f"vals {tuple(vals.shape)} does not match the work "
                         f"list ({wl.nb}, {wl.max_nz}, {bk}, {bn})")
    if bn > 128:
        raise ValueError(f"the walker takes bn <= 128, got {bn}")
    ds = wl.on_device(dev)
    out = torch.empty((M, nb * bn), dtype=torch.float32, device=dev)
    occ = torch.empty((M // sub_m, nb), dtype=torch.int32, device=dev) \
        if emit_occupancy else None
    WALK.launch(dev, patches.data_ptr(), vals.data_ptr(),
                ds.pair_ptr.data_ptr(), ds.k.data_ptr(), ds.j.data_ptr(),
                out.data_ptr(), ptr(occ),
                M, K, nb, M // bm_rows, max_nz, bk, bn, bm_rows, sub_m,
                int(relu), int(emit_occupancy), ncolors, mb_per_img)
    return (out,) if occ is None else (out, occ)


def worklist_spmm(patches: torch.Tensor, vals: torch.Tensor, wl: WorkList, *,
                  vals2: Optional[torch.Tensor] = None, bk: int = LANE,
                  bn: int = LANE, bm_rows: int = DEFAULT_BM,
                  sub_m: Optional[int] = None,
                  mb_per_img: Optional[int] = None, ncolors: int = 1,
                  act: Optional[str] = None, emit_occupancy: bool = False):
    """Run a compacted :class:`WorkList` — ``patches [M, K] @ vals`` over
    exactly the scheduled steps, with the fused epilogue ``act`` (None or
    ``"relu"``) and, when ``emit_occupancy``, the int32 [M / sub_m, nb]
    occupancy of the result. A CUDA tensor launches the walker kernel; a
    CPU tensor runs :func:`worklist_spmm_plain`. ``ncolors`` /
    ``mb_per_img`` carry the §3.3 colouring, which cannot change the
    result here (see ``csrc/walk.cu``). Returns ``(out[, occupancy])``."""
    if vals2 is not None or wl.k2 is not None:
        raise NotImplementedError(
            "the two-stream (gated FFN) walk is not ported yet")
    if act not in (None, "relu"):
        raise NotImplementedError(f"epilogue {act!r} is not ported yet")
    sub_m = bm_rows if sub_m is None else sub_m
    M, K = patches.shape
    if M % bm_rows or K % bk:
        raise ValueError(f"patches [{M}, {K}] do not tile by "
                         f"({bm_rows}, {bk})")
    mb = M // bm_rows
    if wl.mb != mb:
        raise ValueError(f"work list has {wl.mb} row blocks, patches {mb}")
    mb_per_img = mb if mb_per_img is None else mb_per_img
    if patches.device.type == "cpu":
        return worklist_spmm_plain(patches, vals, wl, bk=bk, bn=bn,
                                   bm_rows=bm_rows, sub_m=sub_m, act=act,
                                   emit_occupancy=emit_occupancy)
    if patches.device.type != "cuda":
        raise ValueError(f"no walker for device {patches.device}")
    if emit_occupancy:
        check_row_tiling(bm_rows, sub_m)
    return _worklist_spmm_cuda(patches, vals, wl, bk=bk, bn=bn,
                               bm_rows=bm_rows, sub_m=sub_m,
                               mb_per_img=mb_per_img, ncolors=ncolors,
                               relu=act == "relu",
                               emit_occupancy=emit_occupancy)
