"""Work-list sparse GEMM core (BARISTA §3.2 telescoped scheduling).

Port of ``repro.kernels.worklist_core``, the sparse runtime under the conv
path and the work-list ("compact") FFN schedule:

1. :func:`build_worklist` + :class:`WorkList` — compact a packed weight
   chunk table (optionally ∩ the activation-chunk occupancy, and optionally
   unioned with a second *gate* weight stream for the gated FFN) into
   per-pair slot lists and their flat pair-major serialization. Pure host
   numpy, array-equal to the reference.
2. :func:`worklist_spmm` — run the schedule, one or two weight streams,
   with any epilogue of :data:`ACTS`, in fp32 or bf16 storage. On a CUDA
   tensor it launches the hand-written walker (``csrc/walk.cu``; its tile
   mode also reads x straight from a conv's NHWC map, the tap-slab operand
   of :func:`repro_torch.kernels.sparse_conv.worklist_spmm_slabs`); on a CPU
   tensor it runs the plain version :func:`worklist_spmm_plain` (gather the
   scheduled tile pairs of each stream, one batched matmul each, the
   products summed per (n, m) pair in schedule order, epilogue) — the port
   of the reference's XLA executor (``segment_spmm``).
3. :func:`schedule_stats` — the tensor model of the step counts
   :func:`build_worklist` schedules, and :func:`schedule_counters`, the
   record both engines report.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._cuda import (KERNEL_DTYPES, CudaKernel, I, P,
                                       LaunchCounter, check_cuda_tensor, ptr)
from repro_torch.kernels.grid import (ROW_BLOCK, WALK_KS, GridGeometry,
                                      TapGeometry, WalkTiles, grid_geometry,
                                      lm_grid_problem, sm_count,
                                      walk_im2col_problem, walk_tiles,
                                      walk_tma_problem)

DEFAULT_BM = 128
LANE = 128

# committed cluster-balance bound: per-device scheduled-step counts of a
# mesh-sharded work list stay within this fraction of the mean
SHARD_BALANCE_TOL = 0.10

GATED_ACTS = ("swiglu", "geglu")
ACTS = ("relu", "relu2", "gelu") + GATED_ACTS
# the activation codes of csrc/tile.cuh (None: the identity epilogue)
ACT_CODE = {None: -1, **{a: i for i, a in enumerate(ACTS)}}

WALK = CudaKernel("walk.cu", "walk_spmm", [
    P, P, P, P, P, P, P, P, P,           # x vals vals2 pair_ptr k k2 j out occ
    I, I, I, I, I, I, I, I, I,           # M K nb mb max_nz bk bn bm sub_m
    I, I, I, I, I,                       # act emit_occ ncolors mb_per_img bf16
    I,                                   # col_group (0: the tile mode)
    I, I, I, I,                          # tile rows cols thread_rows tma
    I, I, I, I, I, I, I,                 # map: H W cin kh kw sh sw
    I, I, I, I, I, I,                    # ph0 ph1 pw0 pw1 m_pad img_stride
    P,                                   # res (the residual flush's shortcut)
    P])                                  # stream

# of WALK's launches, those that read x through the tap-slab operand, and
# of those, the ones whose im2col tensor copies were refused
# (``walk_im2col_problem``: plain copies into one stage)
WALK_TAP_SLABS = LaunchCounter("walk_spmm, tap slabs")
WALK_TAP_SLABS_PLAIN = LaunchCounter("walk_spmm, tap slabs, plain copies")
# of WALK's launches, those whose flush adds a shortcut before the
# activation (``tile_kernel_residual``: a ResNet block's last conv)
WALK_RESIDUAL = LaunchCounter("walk_spmm, residual")


# ---------------------------------------------------------------------------
# activation epilogue and occupancy
# ---------------------------------------------------------------------------
def activate(h: torch.Tensor, g: Optional[torch.Tensor],
             act: Optional[str]) -> torch.Tensor:
    """fp32 activation at the accumulator flush (``None`` = identity).
    GELU is the tanh approximation, as ``jax.nn.gelu`` defaults to; SiLU is
    ``g / (1 + exp(-g))``, the formula of the kernels' flush
    (``csrc/tile.cuh``)."""
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
        return g / (1.0 + torch.exp(-g)) * h
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
    and ``k``/``j`` [T], all int32, and ``k2`` [T] of a two-stream list."""

    pair_ptr: torch.Tensor
    k: torch.Tensor
    j: torch.Tensor
    k2: Optional[torch.Tensor] = None


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
    _live: Dict[Tuple[str, int], Tuple[torch.Tensor, ...]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)
    # per-device lists of a cout-sharded walk (local_worklist), by (device,
    # devices)
    _local: Dict[Tuple[int, int], "WorkList"] = dataclasses.field(
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

    @functools.cached_property
    def live_items(self) -> int:
        """Chunk multiplies the walk runs: live (step, stream) pairs."""
        n = int((self.k >= 0).sum())
        return n if self.k2 is None else n + int((self.k2 >= 0).sum())

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
            arrs = (self.pair_ptr(), self.k, self.j) + (
                () if self.k2 is None else (self.k2,))
            ds = DeviceSchedule(*(
                torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                device=device) for a in arrs))
            self._device[key] = ds
        return ds

    def live_steps(self, device, stream: int = 0) -> Tuple[torch.Tensor, ...]:
        """``(n, m, k, j)`` int64 on ``device`` of the steps where weight
        stream ``stream`` (0: ``k``, 1: ``k2``) is live — a step can be live
        in one stream only — for the plain version (copied at its first
        call there, then cached)."""
        key = (str(torch.device(device)), stream)
        live = self._live.get(key)
        if live is None:
            ks = self.k if stream == 0 else self.k2
            if ks is None:
                raise ValueError("a one-stream work list has no stream 1")
            sel = ks >= 0
            live = tuple(torch.as_tensor(a[sel], dtype=torch.int64,
                                         device=device)
                         for a in (self.n, self.m, ks, self.j))
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


def _check_contiguous_shards(wl: WorkList, num_shards: int) -> int:
    """The n-blocks per device of a contiguous equal-count assignment
    (``shard_of`` non-decreasing, ``nb / D`` blocks each: the packer's
    fold-legal form), or raise."""
    if wl.shard_of is None:
        raise ValueError("worklist has no shard_of — pack with mesh_devices")
    if wl.nb % num_shards:
        raise ValueError(f"nb={wl.nb} not divisible by D={num_shards}")
    nbl = wl.nb // num_shards
    expect = np.repeat(np.arange(num_shards), nbl)
    if not np.array_equal(np.asarray(wl.shard_of), expect):
        raise ValueError("SPMD execution needs the contiguous equal-count "
                         "shard assignment (the packer's fold-legal form)")
    return nbl


def shard_worklist_args(wl: WorkList, num_shards: int
                        ) -> Dict[str, np.ndarray]:
    """Split a sharded flat schedule into per-device padded streams (each
    device walks only its own n-blocks, n re-indexed to the device-local
    block range), array-equal to the reference's: only live entries, each
    stream padded to the longest with entries of ``valid == 0``. Needs the
    contiguous equal-count assignment. Returns ``n/m/k/j/valid [D, Tmax]``
    int32."""
    if wl.shard_of is None:
        raise ValueError("work list carries no shard assignment")
    nbl = _check_contiguous_shards(wl, num_shards)
    live = wl.k >= 0
    dev = wl.shard_of[wl.n]
    tmax = max(int(np.max(np.bincount(dev[live], minlength=num_shards),
                          initial=0)), 1)
    out = {f: np.zeros((num_shards, tmax), np.int32)
           for f in ("n", "m", "k", "j", "valid")}
    for d in range(num_shards):
        sel = np.nonzero(live & (dev == d))[0]
        t = sel.size
        out["n"][d, :t] = wl.n[sel] - d * nbl
        out["m"][d, :t] = wl.m[sel]
        out["k"][d, :t] = wl.k[sel]
        out["j"][d, :t] = wl.j[sel]
        out["valid"][d, :t] = 1
    return out


def local_worklist(wl: WorkList, device_index: int,
                   num_shards: int) -> WorkList:
    """Device ``device_index``'s own work list: the schedule of its n-blocks
    with ``n`` re-indexed from 0, flush-only steps kept, what the walker
    kernel walks for one device of a cout-sharded layer. The flat list is
    pair-major with n outermost, so a device's entries are one contiguous
    run; this is ``build_worklist`` over the index rows of those blocks
    with the same occupancy and ``mb_per_img``. Cached on ``wl`` (with its
    own device copy, made once), so a call copies no schedule."""
    key = (int(device_index), int(num_shards))
    loc = wl._local.get(key)
    if loc is None:
        nbl = _check_contiguous_shards(wl, num_shards)
        d = key[0]
        if not 0 <= d < num_shards:
            raise ValueError(f"device {d} not in [0, {num_shards})")
        ptr = wl.pair_ptr()
        lo, hi = int(ptr[d * nbl * wl.mb]), int(ptr[(d + 1) * nbl * wl.mb])
        cut = slice(lo, hi)
        blocks = slice(d * nbl, (d + 1) * nbl)
        steps = wl.steps_per_pair[blocks]
        width = max(int(steps.max(initial=0)), 1)
        loc = WorkList(
            (wl.n[cut] - d * nbl).astype(np.int32), wl.m[cut], wl.k[cut],
            wl.j[cut], wl.first[cut], wl.last[cut],
            np.ascontiguousarray(wl.ragged_idx[blocks, :, :width]), steps,
            nbl, wl.mb, wl.max_nz,
            k2=None if wl.k2 is None else wl.k2[cut],
            mb_per_img=wl.mb_per_img)
        wl._local[key] = loc
    return loc


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
            "dense_grid_steps": torch.full((), nb * mb * max_nz,
                                           dtype=torch.long, device=dev)}


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
    """The walker emits occupancy per ``sub_m``-row sub-block of a row
    block. Its CTAs cut a row block into tiles of 32 to 128 rows (the tile
    mode) or cover 32 rows of several (the grid mode) and OR their rows'
    bits into the sub-block's entry with integer atomics, so a sub-block
    may span CTAs: ``sub_m`` need only divide ``bm_rows``."""
    if sub_m <= 0 or bm_rows % sub_m:
        raise ValueError(f"sub_m={sub_m} must divide bm_rows={bm_rows}")


def _tile_output(acc: torch.Tensor, nb: int, mb: int, bm_rows: int, bn: int,
                 sub_m: int, emit_occupancy: bool):
    """[nb*mb, bm, bn] pair accumulators -> ``(out [M, nb*bn][, occ])``."""
    out = acc.reshape(nb, mb, bm_rows, bn).permute(1, 2, 0, 3) \
             .reshape(mb * bm_rows, nb * bn)
    return _occupancy_of(out, nb, bn, sub_m, emit_occupancy)


def _occupancy_of(out: torch.Tensor, nb: int, bn: int, sub_m: int,
                  emit_occupancy: bool):
    """``(out [M, nb*bn][, occ])``, occ the int32 [M // sub_m, nb]
    occupancy of ``out`` when asked."""
    if not emit_occupancy:
        return (out,)
    M = out.shape[0]
    occ = (out.reshape(M // sub_m, sub_m, nb, bn) != 0).any(dim=3) \
        .any(dim=1).to(torch.int32)
    return (out, occ)


def check_residual(residual: torch.Tensor, M: int, N: int,
                   dtype: torch.dtype, device: torch.device) -> None:
    """A shortcut the walker takes: ``[M, N]`` rows of ``N`` elements, one
    after another, of the output's type, on its device, 16-byte aligned."""
    if tuple(residual.shape) != (M, N) or residual.stride() != (N, 1):
        raise ValueError(f"the shortcut must be [{M}, {N}] with row stride "
                         f"{N}, got {tuple(residual.shape)} strides "
                         f"{residual.stride()}")
    if residual.dtype != dtype or residual.device != device:
        raise ValueError(f"the shortcut is {residual.dtype} on "
                         f"{residual.device}, the output {dtype} on {device}")
    if residual.data_ptr() % 16:
        raise ValueError("the shortcut must be 16-byte aligned")


def worklist_spmm_plain(patches: torch.Tensor, vals: torch.Tensor,
                        wl: WorkList, *, vals2: Optional[torch.Tensor] = None,
                        bk: int, bn: int, bm_rows: int, sub_m: int,
                        act: Optional[str], emit_occupancy: bool,
                        residual: Optional[torch.Tensor] = None):
    """Plain version of the walker, on any device (the port of the
    reference's ``segment_spmm``): per weight stream, gather exactly the
    scheduled (x block, W chunk) tile pairs where that stream is live, one
    batched fp32 matmul, then the products summed per (n, m) pair in
    schedule order (ascending j: one ``index_add_`` per slot rank, so no
    two products of a pass meet and the sum is deterministic on every
    device); then ``activate(acc + residual, acc2, act)`` (``residual``,
    the shortcut in the output's ``[M, nb * bn]`` geometry, where given)
    and one rounding to ``patches``' type. Flush-only steps cost nothing:
    pairs without products stay zero."""
    M, K = patches.shape
    mb, kb = M // bm_rows, K // bk
    x4 = patches.reshape(mb, bm_rows, kb, bk)

    def stream(w: torch.Tensor, which: int) -> torch.Tensor:
        ln, lm, lk, lj = wl.live_steps(patches.device, which)
        prod = torch.bmm(x4[lm, :, lk, :].float(),             # [T, bm, bk]
                         w[ln, lj].float())                    # [T, bk, bn]
        acc = torch.zeros((wl.nb * mb, bm_rows, bn), dtype=torch.float32,
                          device=patches.device)
        pair = ln * mb + lm                    # non-decreasing: pair-major
        rank = torch.arange(pair.numel(), device=pair.device) \
            - torch.searchsorted(pair, pair)
        for r in range(int(rank.max()) + 1 if rank.numel() else 0):
            sel = rank == r
            acc.index_add_(0, pair[sel], prod[sel])
        return acc

    acc = stream(vals, 0)
    acc2 = stream(vals2, 1) if vals2 is not None else None
    if residual is not None:
        acc = acc + residual.float().reshape(mb, bm_rows, wl.nb, bn) \
            .permute(2, 0, 1, 3).reshape(wl.nb * mb, bm_rows, bn)
    out = activate(acc, acc2, act).to(patches.dtype)
    return _tile_output(out, wl.nb, mb, bm_rows, bn, sub_m, emit_occupancy)


def walk_mode(patches: torch.Tensor, vals: torch.Tensor,
              vals2: Optional[torch.Tensor], wl: WorkList, *, bk: int,
              bn: int, bm_rows: int,
              taps: Optional[TapGeometry] = None
              ) -> Union[GridGeometry, WalkTiles]:
    """The walker's mode on the card, chosen by shape before the launch:

    * the grid mode (``csrc/ffn_grid.cuh``, a :class:`GridGeometry`) for
      row blocks dividing 32 whose operands its tensor copies take
      (``lm_grid_problem``: bk and bn multiples of 8, bk <= 248, 16-byte
      rows and alignment);
    * else the tile mode (``csrc/walk.cu``, a :class:`WalkTiles`), CTA tiles
      from :func:`~repro_torch.kernels.grid.walk_tiles` at the card's SM
      count and the ring stages a pair's walk takes on average: a ring of
      tensor copies where ``walk_tma_problem`` finds none, plain copies
      into one stage where it finds one (x rows, weight rows or chunks not
      a multiple of 16 bytes, an operand not 16-byte aligned). The tile
      mode takes every shape the walker does (any bk, bn <= 128, any row
      block).

    With ``taps`` (the tap-slab operand: ``patches`` is the NHWC input map)
    always the tile mode, its x copies im2col tensor copies of the map
    where ``walk_im2col_problem`` finds nothing against them.

    Nothing falls back after a launch: a CUDA tensor launches the mode
    chosen here or raises."""
    dev = patches.device
    M = patches.shape[0] if taps is None else taps.rows
    tensors = [("vals", vals), ("vals2", vals2)]
    if taps is None and ROW_BLOCK % bm_rows == 0 and \
            lm_grid_problem(patches, tensors, bk, bn) is None:
        return grid_geometry(M, wl.nb, bm=bm_rows, bn=bn, sms=sm_count(dev))
    depth = -(-bk // WALK_KS) * wl.live_items / max(wl.num_pairs, 1)
    tiles = walk_tiles(M, wl.nb, bm=bm_rows, bn=bn, depth=depth,
                       sms=sm_count(dev), gated=vals2 is not None)
    if taps is None:
        problem = walk_tma_problem(patches, tensors, bn, bk)
    else:
        problem = walk_im2col_problem(patches, taps, tensors, bk, bn,
                                      tiles.rows)
    if problem is not None:
        tiles = dataclasses.replace(tiles, tma=False)
    return tiles


def map_pixels_contiguous(x: torch.Tensor) -> bool:
    """Whether NHWC ``x`` is laid out as the tap-slab operand reads it:
    each image's pixels contiguous, images any multiple of that apart (a
    layer's output cut from its padded rows is such a view)."""
    B, H, W, C = x.shape
    s = x.stride()
    return (s[3] == 1 or C == 1) and s[2] == C and s[1] == W * C and \
        (B == 1 or s[0] >= H * W * C)


def _worklist_spmm_cuda(patches, vals, vals2, wl, *, bk, bn, bm_rows, sub_m,
                        mb_per_img, ncolors, act, emit_occupancy,
                        taps: Optional[TapGeometry] = None,
                        residual: Optional[torch.Tensor] = None):
    """Launch the walker. ``patches`` is the patch matrix ``[M, K]``, or
    with ``taps`` the NHWC input map it stands for (the tap-slab operand,
    whose work-list chunks name ``(tap, channel group)`` slabs of it).
    ``residual`` is added before ``act`` in the tile mode's flush
    (``tile_kernel_residual``: fp32, one stream, the patch matrix; any
    other launch with one raises)."""
    dev = patches.device
    if taps is None:
        M, K = patches.shape
        geom = (0,) * 13
    else:
        if tuple(patches.shape) != (taps.B, taps.H, taps.W, taps.cin):
            raise ValueError(f"the map {tuple(patches.shape)} does not match "
                             f"its geometry {taps}")
        if not map_pixels_contiguous(patches):
            raise ValueError(f"the tap-slab operand takes a map whose images"
                             f" are contiguous NHWC, got strides "
                             f"{patches.stride()}")
        if taps.cin % bk:
            raise ValueError(f"the tap-slab operand needs cin % bk == 0, got "
                             f"cin={taps.cin} bk={bk}")
        if vals2 is not None:
            raise ValueError("the tap-slab operand takes one weight stream")
        M, K = taps.rows, taps.k
        geom = (taps.H, taps.W, taps.cin, taps.kh, taps.kw, taps.sh, taps.sw,
                taps.ph0, taps.ph1, taps.pw0, taps.pw1, taps.m_pad,
                patches.stride(0) if taps.B > 1 else
                taps.H * taps.W * taps.cin)
        live = wl.k[wl.k >= 0]
        if live.size and int(live.max()) >= K // bk:
            raise ValueError(f"the work list names chunk {int(live.max())} "
                             f"of a map with {K // bk}")
    if patches.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the walker takes {KERNEL_DTYPES}, got "
                         f"{patches.dtype}")
    if taps is None:
        check_cuda_tensor("patches", patches, patches.dtype, dev)
    nb, max_nz = wl.nb, wl.max_nz
    for name, w in (("vals", vals), ("vals2", vals2)):
        if w is None:
            continue
        check_cuda_tensor(name, w, patches.dtype, dev)
        if tuple(w.shape) != (nb, max_nz, bk, bn):
            raise ValueError(f"{name} {tuple(w.shape)} does not match the "
                             f"work list ({nb}, {max_nz}, {bk}, {bn})")
    if bn > 128:
        raise ValueError(f"the walker takes bn <= 128, got {bn}")
    if M % bm_rows or K % bk:
        raise ValueError(f"{M} rows and {K} columns do not tile by "
                         f"({bm_rows}, {bk})")
    mode = walk_mode(patches, vals, vals2, wl, bk=bk, bn=bn, bm_rows=bm_rows,
                     taps=taps)
    if residual is not None:
        if isinstance(mode, GridGeometry) or taps is not None or \
                vals2 is not None or patches.dtype != torch.float32:
            raise ValueError("the residual flush is the tile mode's, fp32, "
                             "one stream, on the patch matrix")
        check_residual(residual, M, nb * bn, patches.dtype, dev)
    if isinstance(mode, GridGeometry):
        col_group, tile = mode.col_group, (0, 0, 0, 0)
    else:
        col_group = 0
        tile = (mode.rows, mode.cols, mode.thread_rows, int(mode.tma))
    ds = wl.on_device(dev)
    out = torch.empty((M, nb * bn), dtype=patches.dtype, device=dev)
    occ = torch.empty((M // sub_m, nb), dtype=torch.int32, device=dev) \
        if emit_occupancy else None
    WALK.launch(dev, patches.data_ptr(), vals.data_ptr(), ptr(vals2),
                ds.pair_ptr.data_ptr(), ds.k.data_ptr(), ptr(ds.k2),
                ds.j.data_ptr(), out.data_ptr(), ptr(occ),
                M, K, nb, M // bm_rows, max_nz, bk, bn, bm_rows, sub_m,
                ACT_CODE[act], int(emit_occupancy), ncolors, mb_per_img,
                int(patches.dtype == torch.bfloat16), col_group, *tile,
                *geom, ptr(residual))
    if residual is not None:
        WALK_RESIDUAL.count(dev)
    if taps is not None:
        WALK_TAP_SLABS.count(dev)
        if not mode.tma:
            WALK_TAP_SLABS_PLAIN.count(dev)
    return (out,) if occ is None else (out, occ)


def worklist_spmm(patches: torch.Tensor, vals: torch.Tensor, wl: WorkList, *,
                  vals2: Optional[torch.Tensor] = None, bk: int = LANE,
                  bn: int = LANE, bm_rows: int = DEFAULT_BM,
                  sub_m: Optional[int] = None,
                  mb_per_img: Optional[int] = None, ncolors: int = 1,
                  act: Optional[str] = None, emit_occupancy: bool = False,
                  residual: Optional[torch.Tensor] = None):
    """Run a compacted :class:`WorkList` — ``patches [M, K] @ vals`` (and,
    for a two-stream list, ``@ vals2``, the gate stream) over exactly the
    scheduled steps, with the fused epilogue ``act`` (None or one of
    :data:`ACTS`; the gated acts read the second accumulator) and, when
    ``emit_occupancy``, the int32 [M / sub_m, nb] occupancy of the result.
    fp32 or bf16 storage, fp32 sums, output in ``patches``' type. A CUDA
    tensor launches the walker kernel in the mode :func:`walk_mode` picks
    by shape (its grid mode for ``bm_rows`` dividing 32, its tile mode
    otherwise); a CPU tensor runs
    :func:`worklist_spmm_plain`. ``ncolors`` / ``mb_per_img`` carry the
    §3.3 colouring, which cannot change the result here (see
    ``csrc/walk.cu``). ``residual`` ``[M, nb * bn]`` (a row stride of
    ``nb * bn``, 16-byte aligned) is added to ``acc`` before ``act``, the
    occupancy then that of the sum: on the card in the tile mode's flush,
    fp32, one stream (``WALK_RESIDUAL`` counts those launches). Returns
    ``(out[, occupancy])``."""
    if (vals2 is not None) != (wl.k2 is not None):
        raise ValueError("a two-stream work list (gate_indices) needs vals2,"
                         " a one-stream list takes none")
    if act is not None and act not in ACTS:
        raise ValueError(f"act must be None or one of {ACTS}, got {act!r}")
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
        if residual is not None:
            check_residual(residual, M, wl.nb * bn, patches.dtype,
                           patches.device)
        return worklist_spmm_plain(patches, vals, wl, vals2=vals2, bk=bk,
                                   bn=bn, bm_rows=bm_rows, sub_m=sub_m,
                                   act=act, emit_occupancy=emit_occupancy,
                                   residual=residual)
    if patches.device.type != "cuda":
        raise ValueError(f"no walker for device {patches.device}")
    if emit_occupancy:
        check_row_tiling(bm_rows, sub_m)
    return _worklist_spmm_cuda(patches, vals, vals2, wl, bk=bk, bn=bn,
                               bm_rows=bm_rows, sub_m=sub_m,
                               mb_per_img=mb_per_img, ncolors=ncolors,
                               act=act, emit_occupancy=emit_occupancy,
                               residual=residual)


def worklist_spmm_padded_plain(patches: torch.Tensor, vals: torch.Tensor,
                               wl_n: torch.Tensor, wl_m: torch.Tensor,
                               wl_k: torch.Tensor, wl_j: torch.Tensor,
                               valid: torch.Tensor, *, bk: int, bn: int,
                               bm_rows: int, nb_local: int, mb: int,
                               act: Optional[str] = None) -> torch.Tensor:
    """Plain version of one device's walk of its padded stream (from
    :func:`shard_worklist_args`): the reference's ``worklist_spmm_padded``.
    Padding entries (``valid == 0``) gather a clamped but real tile pair and
    send its product to a discard segment past the pair grid, so they never
    touch the output; each real pair sums its live chunks in ascending-j
    order as :func:`worklist_spmm_plain` does (one ``index_add_`` per slot
    rank), so the slab is bitwise that function's matching column block.
    ``vals`` holds the device's ``nb_local`` row blocks. Returns
    ``[M, nb_local * bn]``."""
    M, K = patches.shape
    kb = K // bk
    nc = wl_n.long().clamp(0, nb_local - 1)
    mc = wl_m.long().clamp(0, mb - 1)
    kc = wl_k.long().clamp(0, kb - 1)
    jc = wl_j.long().clamp_min(0)
    x4 = patches.reshape(mb, bm_rows, kb, bk)
    prod = torch.bmm(x4[mc, :, kc, :].float(), vals[nc, jc].float())
    pair = torch.where(valid > 0, nc * mb + mc,
                       torch.full_like(nc, nb_local * mb))
    acc = torch.zeros((nb_local * mb + 1, bm_rows, bn), dtype=torch.float32,
                      device=patches.device)
    # live entries are pair-major and the padding sits last: non-decreasing
    rank = torch.arange(pair.numel(), device=pair.device) \
        - torch.searchsorted(pair, pair)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        acc.index_add_(0, pair[sel], prod[sel])
    out = activate(acc[:-1], None, act).to(patches.dtype)
    return _tile_output(out, nb_local, mb, bm_rows, bn, bm_rows, False)[0]


def worklist_spmm_padded(patches: torch.Tensor, vals: torch.Tensor,
                         wl: WorkList, device_index: int, num_shards: int, *,
                         bk: int = LANE, bn: int = LANE,
                         bm_rows: int = DEFAULT_BM,
                         sub_m: Optional[int] = None,
                         mb_per_img: Optional[int] = None, ncolors: int = 1,
                         act: Optional[str] = None,
                         emit_occupancy: bool = False):
    """One device's walk of a cout-sharded layer: ``patches [M, K]`` against
    ``vals``, the device's own ``nb / D`` row blocks of the packed weights,
    over its share of ``wl`` (which must carry the contiguous equal-count
    ``shard_of``). Returns ``(slab [M, nb/D * bn][, occupancy [M / sub_m,
    nb/D]])``, the matching column blocks of :func:`worklist_spmm` over the
    whole list, bitwise.

    It walks the device's local work list (:func:`local_worklist`: its own
    steps, flush-only ones included, every pair written, built once and
    cached on ``wl``) through :func:`worklist_spmm`: the walker kernel on a
    CUDA tensor, its plain version on a CPU tensor. The reference's padded
    stream walk is :func:`worklist_spmm_padded_plain`, which the tests hold
    this against."""
    if wl.k2 is not None:
        raise ValueError("a cout-sharded walk takes a one-stream work list")
    nbl = _check_contiguous_shards(wl, num_shards)
    if tuple(vals.shape[:2]) != (nbl, wl.max_nz):
        raise ValueError(f"vals {tuple(vals.shape)} are not device "
                         f"{device_index}'s {nbl} row blocks of "
                         f"{wl.max_nz} slots")
    loc = local_worklist(wl, device_index, num_shards)
    return worklist_spmm(patches, vals, loc, bk=bk, bn=bn, bm_rows=bm_rows,
                         sub_m=sub_m, mb_per_img=mb_per_img, ncolors=ncolors,
                         act=act, emit_occupancy=emit_occupancy)
