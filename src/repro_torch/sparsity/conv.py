"""Conv-aware BARISTA offline packing path (port of ``repro.sparsity.conv``).

The packing chain runs prune -> balance -> fold -> pack. Conv filters are
[kh, kw, Cin, Cout] tensors; the paper's accelerator linearizes them
through its matrix interface (im2col), so the conv path adds two
conv-specific steps:

* **matrixization** — two layouts. ``layout="channel"`` (the unstructured
  default) is ``w.transpose(2, 0, 1, 3).reshape(Cin*kh*kw, Cout)``,
  matching ``conv_general_dilated_patches`` feature order.
  ``layout="tap"`` (the chunk-aligned pattern) is the plain
  ``w.reshape(kh*kw*Cin, Cout)`` — K index = tap * Cin + channel — so a
  K-chunk lies inside one filter tap and a live chunk maps to one
  shifted-slab slice of the input. Both are chunk-padded for the
  kernels' tile grid.
* **chain folding** — greedy-balancing layer *i*'s output channels permutes
  the feature map's channel axis; the repair is folding the inverse into
  layer *i+1*'s **input-channel** axis (axis 2 of the 4-D filter), which is
  legal across ReLU and max-pool because both act per-channel. The last
  layer keeps identity so the network's output channels are unpermuted.
  The chunk pattern folds *bank-granular* permutations through the same
  path (whole ``bn`` blocks, so tile alignment survives the fold).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import balance, bitmask as bm
from repro_torch.core.sparse import prune_by_magnitude
from repro_torch.kernels.worklist_core import (SHARD_BALANCE_TOL,
                                               shard_imbalance,
                                               shard_scaling_efficiency)
from repro_torch.sparsity import structured


def matrixize_filters(w: np.ndarray, chunk: int = bm.CHUNK,
                      layout: str = "channel", *, bk: Optional[int] = None,
                      bn: Optional[int] = None) -> np.ndarray:
    """[kh, kw, Cin, Cout] -> block-padded [K, N] (K = Cin*kh*kw, N = Cout).

    ``layout="channel"`` uses channel-major feature order (the
    ``conv_general_dilated_patches`` layout); ``layout="tap"`` keeps the
    tensor's natural tap-major order (K = tap * Cin + c). K pads to
    ``bk`` blocks and N to ``bn`` blocks (both default to ``chunk``).
    """
    kh, kw, cin, cout = w.shape
    bk = chunk if bk is None else bk
    bn = chunk if bn is None else bn
    if layout == "channel":
        w_mat = np.asarray(w).transpose(2, 0, 1, 3).reshape(
            kh * kw * cin, cout)
    elif layout == "tap":
        if cin % bk != 0:
            raise ValueError(f"tap layout needs cin % bk == 0, got "
                             f"cin={cin} bk={bk}")
        w_mat = np.asarray(w).reshape(kh * kw * cin, cout)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    pad_k = (-w_mat.shape[0]) % bk
    pad_n = (-cout) % bn
    return np.pad(w_mat, ((0, pad_k), (0, pad_n)))


def pack_conv_filters(w: np.ndarray, chunk: int = bm.CHUNK,
                      pad_to: Optional[int] = None, *,
                      layout: str = "channel", bk: Optional[int] = None,
                      bn: Optional[int] = None,
                      device="cuda") -> bm.BlockSparseMatrix:
    """Pack (already pruned) conv filters into the chunk-block-sparse layout
    the implicit-GEMM kernels consume, on ``device``."""
    bk = chunk if bk is None else bk
    bn = chunk if bn is None else bn
    return bm.block_sparsify(
        matrixize_filters(w, chunk, layout, bk=bk, bn=bn), bk=bk, bn=bn,
        pad_to=pad_to, device=device)


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Cluster (mesh-device) assignment of one layer's packed n-blocks.

    The §4 round-robin load-balance story lifted from lanes to clusters:
    ``assign[b]`` is the device that owns output-chunk block ``b`` *in the
    packed (post-permutation) block order*, so it is always contiguous
    non-decreasing — the shard permutation groups each device's blocks
    together, which is what keeps the fold into the next layer's cin axis
    legal (whole blocks move, tile alignment survives) and lets the SPMD
    executor reassemble the output by concatenating per-device slabs in
    ring order. ``block_steps[b]`` is the block's static per-row-block
    scheduled-step count (``max(live chunks, 1)`` — live MACs or the one
    flush-only step), the unit the balance minimizes.
    """

    num_devices: int
    assign: np.ndarray            # [nb] int32, contiguous non-decreasing
    block_steps: np.ndarray       # [nb] int64 static steps per n-block
    mode: str                     # "greedy" | "contiguous"
    tolerance: float = SHARD_BALANCE_TOL

    @property
    def device_steps(self) -> np.ndarray:
        return np.bincount(self.assign, weights=self.block_steps,
                           minlength=self.num_devices).astype(np.int64)

    @property
    def imbalance(self) -> float:
        return shard_imbalance(self.device_steps)

    @property
    def scaling_efficiency(self) -> float:
        return shard_scaling_efficiency(self.device_steps)


def chunk_block_steps(mat: np.ndarray, bk: int, bn: int) -> np.ndarray:
    """Static per-n-block scheduled steps of a matrixized layer: live
    k-chunks per ``bn``-column block, floored at 1 (a fully dead block
    still costs its flush-only step per row block)."""
    kb, nbt = mat.shape[0] // bk, mat.shape[1] // bn
    occ = (mat.reshape(kb, bk, nbt, bn) != 0).any(axis=(1, 3))
    return np.maximum(occ.sum(axis=0), 1).astype(np.int64)


def mesh_shard_assignment(block_steps: np.ndarray, num_devices: int
                          ) -> Tuple[np.ndarray, str]:
    """Assign n-blocks to mesh devices balancing static scheduled steps.

    Two candidates are scored and the better one wins, so the mesh-aware
    result is never worse than the lane-only layout:

    * **contiguous** — equal split of the current (lane-balanced) block
      order: what plain cout-sharding of the existing layout gives.
    * **greedy** — longest-processing-time first under an equal-count
      capacity (each device takes at most ``ceil(nb / D)`` blocks): the
      §4 round-robin policy applied across clusters, with the count cap
      keeping per-device packed shapes equal for SPMD execution.

    Returns ``(assign, mode)`` with ``assign`` labeling blocks in their
    *current* order (not yet contiguous — the caller's shard permutation
    groups them).
    """
    block_steps = np.asarray(block_steps, np.int64)
    nb = block_steps.size
    d = max(1, min(int(num_devices), nb))
    sizes = [nb // d + (1 if r < nb % d else 0) for r in range(d)]
    contiguous = np.repeat(np.arange(d), sizes).astype(np.int32)
    cap = -(-nb // d)
    load = np.zeros(d, np.int64)
    count = np.zeros(d, np.int64)
    greedy = np.zeros(nb, np.int32)
    for b in np.argsort(-block_steps, kind="stable"):
        open_devs = np.nonzero(count < cap)[0]
        dev = open_devs[np.argmin(load[open_devs])]
        greedy[b] = dev
        load[dev] += block_steps[b]
        count[dev] += 1

    def imb(assign):
        return shard_imbalance(np.bincount(assign, weights=block_steps,
                                           minlength=d))

    if imb(greedy) < imb(contiguous) - 1e-12:
        return greedy, "greedy"
    return contiguous, "contiguous"


@dataclasses.dataclass
class PackedConv:
    """One conv layer, offline-processed: pruned (permuted/folded) dense
    filters kept for the oracle, plus their packed kernel form.

    The packed layout keeps its chunk index lists on the host
    (``packed.indices_np``, set at pack time), so building a schedule never
    reads back from the device; ``wl_cache`` memoizes the static (weight-side)
    telescoped work lists per row-block count — the offline part of the
    §3.2 compaction, computed once per (layer, batch geometry).

    ``layout``/``pattern`` record how the filters were matrixized and
    pruned (``"channel"``+``"unstructured"`` is the legacy path); ``tuned``
    holds the autotuner's winning per-layer tile config
    (:class:`repro_torch.kernels.autotune.TuneRecord`) once
    :func:`repro_torch.kernels.autotune.autotune_conv` has run, and
    ``compile_forward(use_tuned=True)`` runs the layer at it."""

    w_dense: np.ndarray           # [kh, kw, Cin, Cout] pruned, chain-folded
    packed: bm.BlockSparseMatrix
    perm: np.ndarray              # balance permutation of the Cout axis
    wl_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)
    layout: str = "channel"
    pattern: str = "unstructured"
    prune_info: Optional[structured.ChunkPruneInfo] = \
        dataclasses.field(default=None, repr=False, compare=False)
    tuned: Optional[Any] = dataclasses.field(default=None, repr=False,
                                             compare=False)
    # cluster assignment of the packed n-blocks (mesh-aware balance step);
    # None on chains built without mesh_devices. ``packed.shard_of``
    # mirrors ``shard.assign`` so the work lists carry it.
    shard: Optional[ShardInfo] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    @property
    def kh(self) -> int:
        return self.w_dense.shape[0]

    @property
    def kw(self) -> int:
        return self.w_dense.shape[1]

    @property
    def cin(self) -> int:
        return self.w_dense.shape[2]

    @property
    def cout(self) -> int:
        return self.w_dense.shape[3]

    def scalar_density(self) -> float:
        return float((self.w_dense != 0).mean())

    def chunk_density(self) -> float:
        """Live fraction of the packed chunk map the work list is built
        from. A 1.0 reading at 0.33 scalar density is a *pattern
        artifact*, not a measurement bug: unstructured pruning leaves a
        survivor in every (bk, bn) tile."""
        return self.packed.density()

    def dead_chunk_fraction(self) -> float:
        return 1.0 - self.chunk_density()


def build_sparse_chain(weights: Sequence[np.ndarray], *, density: float = 1.0,
                       num_shards: int = 16, chunk: int = bm.CHUNK,
                       balance_filters: bool = True,
                       pattern: str = "unstructured",
                       micro_ranges: int = 3,
                       mesh_devices: Optional[int] = None,
                       strict: bool = False,
                       device="cuda") -> List[PackedConv]:
    """Offline pipeline for a sequential conv chain: prune -> balance ->
    fold into the next layer -> matrixize -> pack.

    ``weights[i]`` is [kh, kw, Cin_i, Cout_i] with Cout_i == Cin_{i+1}.

    ``strict=True`` runs the artifact verifier over the packed chain
    (:func:`repro_torch.analysis.verify_graph`) and raises
    :class:`~repro_torch.analysis.AnalysisError` on any error. The packed
    tiles land on ``device``.

    ``pattern="unstructured"`` (default) is the legacy path: per-filter
    magnitude pruning, per-channel greedy balance, channel-major packing.
    ``pattern="chunk"`` prunes at (bk, bn) tile granularity in the
    tap-major layout (:mod:`repro_torch.sparsity.structured`) so the packed
    chunk maps have real dead chunks; balancing then moves whole banks
    (per-channel balance would scramble tile columns), and layers too
    narrow for tap chunks (the 3-channel stem) fall back to unstructured
    pruning in the channel layout — per-layer scalar density stays on
    target either way.  Balancing alternates direction per layer (the
    paper's two fixed permutations); the final layer is left unpermuted.

    ``mesh_devices`` (optional) adds the *cluster-level* balance pass on
    top of the lane balance: each layer's packed n-blocks are assigned to
    ``min(mesh_devices, n_blocks)`` devices by
    :func:`mesh_shard_assignment` (greedy §4 round-robin vs the
    contiguous lane-only split — whichever balances static per-device
    scheduled steps better), and the block-granular shard permutation
    that groups each device's blocks contiguously is folded into the next
    layer's cin axis exactly like the lane permutation. The last layer is
    never permuted (its contiguous assignment is recorded as-is), and a
    cout that is not whole ``bn`` blocks keeps the contiguous split (a
    partial block cannot move without breaking the packed padding).
    """
    n = len(weights)
    return build_sparse_graph(weights, [None] * n, [None] * n,
                              density=density, num_shards=num_shards,
                              chunk=chunk, balance_filters=balance_filters,
                              pattern=pattern, micro_ranges=micro_ranges,
                              mesh_devices=mesh_devices, strict=strict,
                              device=device)


def map_groups(adds: Sequence[Optional[int]]) -> List[int]:
    """For each layer's output map, the first layer of the maps that adds
    join with it (``adds[i]``: the layer whose output layer ``i`` adds, or
    None): the sum of two maps carries one channel order, so each group
    shares one permutation."""
    root = list(range(len(adds)))

    def find(i: int) -> int:
        while root[i] != i:
            i = root[i]
        return i

    for i, a in enumerate(adds):
        if a is not None:
            lo, hi = sorted((find(i), find(a)))
            root[hi] = lo
    return [find(i) for i in range(len(adds))]


def build_sparse_graph(weights: Sequence[np.ndarray],
                       srcs: Sequence[Optional[int]],
                       adds: Sequence[Optional[int]], *,
                       density: float = 1.0, num_shards: int = 16,
                       chunk: int = bm.CHUNK, balance_filters: bool = True,
                       pattern: str = "unstructured",
                       micro_ranges: int = 3,
                       mesh_devices: Optional[int] = None,
                       strict: bool = False,
                       device="cuda") -> List[PackedConv]:
    """The offline pipeline of :func:`build_sparse_chain` for a graph of
    convs (a ResNet): layer ``i`` reads the output of layer ``srcs[i]``
    (-1: the image; None: the layer before) and adds that of ``adds[i]``
    (None: nothing) before its activation. :func:`build_sparse_chain` is
    this packer on a chain.

    Permutations belong to maps, not layers. The maps an add joins (a
    stage's trunk) share one (:func:`map_groups`), set by the first layer
    that writes the group, by the chain's rule (greedy balance of its
    pruned filters, or whole banks under ``pattern="chunk"``; direction by
    its index), or the identity for the group of the last layer's map (the
    network's outputs leave unpermuted). Every layer permutes its output
    channels by its map's permutation and folds its source map's into its
    input channels before pruning, as the chain folds layer ``i``'s into
    layer ``i + 1``. ``mesh_devices`` (a chain only) runs the chain's
    cluster balance pass, whose block permutation joins the map's.
    ``strict=True`` runs :func:`repro_torch.analysis.verify_graph` over
    the result."""
    if pattern not in ("unstructured", "chunk"):
        raise ValueError(f"unknown pattern {pattern!r}")
    n = len(weights)
    if len(srcs) != n or len(adds) != n:
        raise ValueError(f"{n} layers, {len(srcs)} sources, {len(adds)} adds")
    ws = [np.asarray(w, np.float32) for w in weights]
    src = [i - 1 if s is None else int(s) for i, s in enumerate(srcs)]
    mesh = mesh_devices is not None and mesh_devices > 1
    if mesh and (src != list(range(-1, n - 1)) or any(
            a is not None for a in adds)):
        raise ValueError("the cluster balance pass (mesh_devices) packs a "
                         "chain")
    for i, (s, a) in enumerate(zip(src, adds)):
        if not -1 <= s < i or (a is not None and not 0 <= a < i):
            raise ValueError(f"layer {i} reads layer {s} and adds layer {a}: "
                             f"a layer reads and adds earlier layers only")
        if s >= 0 and ws[s].shape[3] != ws[i].shape[2]:
            raise ValueError(f"layer {i}: cin={ws[i].shape[2]}, its source "
                             f"layer {s} has cout={ws[s].shape[3]}")
        if a is not None and ws[a].shape[3] != ws[i].shape[3]:
            raise ValueError(f"layer {i}: cout={ws[i].shape[3]} adds layer "
                             f"{a}'s {ws[a].shape[3]} channels")
    group = map_groups(adds)
    final = group[n - 1] if n else None
    perms = {}                       # group -> its permutation
    out: List[PackedConv] = []
    for i, w in enumerate(ws):
        if src[i] >= 0:
            # the layer reads its source map in that map's channel order
            w = balance.fold_permutation(w, perms[group[src[i]]], axis_in=2)
        layout, bk, bn = ("channel", chunk, chunk)
        info = None
        if pattern == "chunk":
            layout, bk, bn = structured.choose_chunk_layout(w.shape, chunk)
        if density < 1.0:
            if pattern == "chunk" and layout == "tap":
                w, info = structured.prune_chunk_aligned(
                    w, density, bk=bk, bn=bn, micro_ranges=micro_ranges)
            else:
                w = w * prune_by_magnitude(w, density, axis_out=-1)
        g = group[i]
        if g not in perms:
            perm = np.arange(w.shape[3])
            if balance_filters and g != final:
                if pattern == "unstructured":
                    perm = balance.greedy_balance(
                        balance.filter_density(w, axis_out=-1), num_shards,
                        direction=i)
                elif info is not None:
                    perm = structured.bank_balance_permutation(
                        info.keep, bn, w.shape[3], direction=i)
            perms[g] = perm
        perm = perms[g]
        w = w[..., perm]
        if info is not None and w.shape[3] % bn == 0:
            info = dataclasses.replace(
                info, keep=info.keep[:, perm[::bn] // bn],
                quota=info.quota[perm[::bn] // bn])
        shard = None
        if mesh:
            mat = matrixize_filters(w, chunk, layout, bk=bk, bn=bn)
            steps = chunk_block_steps(mat, bk, bn)
            cout = w.shape[3]
            movable = g != final and cout % bn == 0
            if movable:
                assign, mode = mesh_shard_assignment(steps, mesh_devices)
            else:
                d = max(1, min(int(mesh_devices), steps.size))
                sizes = [steps.size // d + (1 if r < steps.size % d else 0)
                         for r in range(d)]
                assign = np.repeat(np.arange(d), sizes).astype(np.int32)
                mode = "contiguous"
            if movable and not np.all(assign[:-1] <= assign[1:]):
                # group each device's blocks contiguously; the
                # block-granular permutation joins the map's, which the
                # readers fold
                mblk = np.argsort(assign, kind="stable")
                mperm = (mblk[:, None] * bn
                         + np.arange(bn)[None, :]).reshape(-1)
                w = w[..., mperm]
                perm = perms[g] = perm[mperm]
                steps = steps[mblk]
                assign = assign[mblk]
                if info is not None:
                    info = dataclasses.replace(
                        info, keep=info.keep[:, mblk], quota=info.quota[mblk])
            shard = ShardInfo(int(assign.max()) + 1, assign, steps, mode)
        packed = pack_conv_filters(w, chunk, layout=layout, bk=bk, bn=bn,
                                   device=device)
        if shard is not None:
            packed.shard_of = shard.assign
        out.append(PackedConv(w, packed, perm, layout=layout,
                              pattern=pattern if layout == "tap"
                              else ("unstructured" if pattern == "chunk"
                                    else pattern),
                              prune_info=info, shard=shard))
    if strict:
        # local import: repro_torch.analysis imports this module
        from repro_torch.analysis import raise_on_errors, verify_graph
        raise_on_errors(verify_graph(out, srcs, adds), "build_sparse_graph")
    return out
