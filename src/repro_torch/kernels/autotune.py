"""Pack-time per-layer tile autotuner for the sparse conv pipeline (port of
``repro.kernels.autotune``).

One tile shape does not fit a whole network: the 3-channel stem wants one
small GEMM over channel-major patches, the wide layers tall row blocks and
the lazy tap-slab operand, and the right n-block width (``bn``) trades
schedule length against GEMM width per layer. This module scores candidate
``(bm_rows, bn, sub_m, im2col)`` configs for each
:class:`~repro_torch.sparsity.conv.PackedConv` and caches the winner on the
layer (``conv.tuned``); :func:`repro_torch.vision.model.compile_forward`
with ``use_tuned=True`` runs every layer at its winner.

Scoring is deterministic and device-free by default: the step counts come
from :func:`repro_torch.kernels.worklist_core.schedule_stats` (its static
all-live mode: the counts ``build_worklist`` schedules), combined with the
reference's element-count cost model, whose ``COST_*`` weights are kept as
they are so that the port picks what the reference picks (they were fitted
on XLA:CPU, not on the H100):

* MACs, ``live_steps * bm * bk * bn``, weight 1;
* im2col bytes: the whole ``M x K`` patch matrix for the eager strategies,
  the live union of tap slabs for ``lazy``;
* a per-step overhead, which favours taller ``bm_rows``.

``measure=True`` times each candidate through
:func:`~repro_torch.kernels.sparse_conv.sparse_conv2d_nhwc` on a calibration
input instead: CUDA events around the layer's calls on the card,
``time.perf_counter`` on the CPU.

Bitwise safety: every candidate keeps the layer's pack-time ``bk``, and each
output element's fp32 sum runs the same ascending chunk order whatever
``bm_rows`` / ``bn`` / ``sub_m`` / strategy, so the tuned network is
bitwise the default one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitmask as bm
from repro_torch.kernels.sparse_conv import conv_out_size, sparse_conv2d_nhwc
from repro_torch.kernels.worklist_core import DEFAULT_BM, schedule_stats
from repro_torch.sparsity.conv import PackedConv, matrixize_filters, \
    pack_conv_filters

# cost-model weights, in units of one GEMM MAC (the reference's, fitted on
# its XLA:CPU vision bench)
COST_MAC = 1.0
COST_EXTRACT = {"patches": 25.0, "slices": 12.0, "taps": 7.0, "lazy": 7.0}
COST_GATHER = 2.0          # per gathered x element, work-list executors
COST_STEP = 20_000.0       # per scheduled step: dispatch + segment/flush
COST_OCC = 0.5             # per occupancy-map entry (sub_m granularity)


@dataclasses.dataclass(frozen=True)
class ConvTileConfig:
    """One runtime tile configuration for a conv layer."""
    bm_rows: int = DEFAULT_BM
    bn: Optional[int] = None          # None: keep the pack-time bn
    sub_m: int = 8
    im2col: str = "auto"

    def key(self) -> Tuple:
        return (self.bm_rows, self.bn, self.sub_m, self.im2col)


@dataclasses.dataclass
class TuneRecord:
    """Autotune outcome cached on ``PackedConv.tuned``."""
    config: ConvTileConfig
    cost: float
    counts: Dict[str, int]            # predicted schedule counts (winner)
    table: List[Tuple[ConvTileConfig, float, Dict[str, int]]]
    m_img: int
    batch: int
    measured: bool = False

    def as_dict(self) -> Dict:
        """JSON-friendly form for bench records."""
        c = self.config
        return {"bm_rows": c.bm_rows, "bn": c.bn, "sub_m": c.sub_m,
                "im2col": c.im2col, "cost": self.cost,
                "measured": self.measured,
                "counts": {k: int(v) for k, v in self.counts.items()},
                "candidates": len(self.table)}


def _occupancy_indices(w_mat: np.ndarray, bk: int, bn: int) -> np.ndarray:
    """Chunk index lists ([nb, max_nz], -1 padded) of a dense [K, N] matrix
    re-cut at (bk, bn): the occupancy half of ``block_sparsify``."""
    K, N = w_mat.shape
    if K % bk or N % bn:
        raise ValueError(f"[{K}, {N}] does not tile by ({bk}, {bn})")
    kb, nb = K // bk, N // bn
    occupied = (w_mat.reshape(kb, bk, nb, bn) != 0).any(axis=(1, 3)).T
    max_nz = max(int(occupied.sum(1).max(initial=0)), 1)
    indices = np.full((nb, max_nz), -1, np.int32)
    for n in range(nb):
        ks = np.nonzero(occupied[n])[0]
        indices[n, : ks.shape[0]] = ks
    return indices


def candidate_configs(conv: PackedConv, m_img: int, *,
                      batch: int = 1) -> List[ConvTileConfig]:
    """Deterministic candidate grid for one layer: ``bm_rows`` the default
    block and the whole-image block (64-aligned, at most 4096 rows);
    ``bn`` the pack-time width and the chunk-compatible alternatives;
    ``im2col`` the strategies legal for the layer's layout."""
    m_img = int(m_img)
    cout = conv.cout
    bms = {DEFAULT_BM}
    whole = -(-m_img // 64) * 64
    if whole <= 4096:
        bms.add(whole)
    bns = {conv.packed.bn}
    for cand in (64, bm.CHUNK):
        if cout % cand == 0:
            bns.add(cand)
    strategies = (("taps", "lazy") if conv.layout == "tap"
                  else ("patches", "slices"))
    return [ConvTileConfig(bm_rows=bmr, bn=bnn, sub_m=8, im2col=s)
            for bmr in sorted(bms) for bnn in sorted(bns)
            for s in strategies]


def _indices_at(conv: PackedConv, bn: int) -> np.ndarray:
    """The layer's chunk index lists at n-block width ``bn``."""
    if bn == conv.packed.bn:
        return conv.packed.host_indices()
    w_mat = matrixize_filters(conv.w_dense, layout=conv.layout,
                              bk=conv.packed.bk, bn=bn)
    return _occupancy_indices(w_mat, conv.packed.bk, bn)


def score_config(cfg: ConvTileConfig, conv: PackedConv, m_img: int, *,
                 batch: int = 1,
                 occ_blk: Optional[np.ndarray] = None
                 ) -> Tuple[float, Dict[str, int]]:
    """Deterministic cost of one candidate: the schedule counts of
    :func:`schedule_stats` (static mode unless a calibration occupancy is
    given) and the element-count cost terms. Returns ``(cost, counts)``;
    lower is better."""
    bk = conv.packed.bk
    bn = cfg.bn if cfg.bn is not None else conv.packed.bn
    k_total = conv.packed.shape[0]
    m_pad = m_img + (-m_img) % cfg.bm_rows
    mb = batch * m_pad // cfg.bm_rows
    indices = _indices_at(conv, bn)
    idx = torch.as_tensor(indices)
    if occ_blk is not None:
        occ = np.tile(np.asarray(occ_blk, bool), (batch, 1))[:mb]
        stats = schedule_stats(None, idx, bk=bk, bm_rows=cfg.bm_rows,
                               occ=torch.as_tensor(occ))
    else:
        stats = schedule_stats(None, idx, bk=bk, bm_rows=cfg.bm_rows, mb=mb)
    counts = {k: int(stats[k]) for k in
              ("live_chunk_steps", "dead_pairs", "scheduled_steps",
               "dense_grid_steps")}
    live = counts["live_chunk_steps"]
    kb = k_total // bk
    M = batch * m_pad
    mac = COST_MAC * live * cfg.bm_rows * bk * bn
    if cfg.im2col == "lazy":
        union = np.unique(indices[indices >= 0])
        extract = COST_EXTRACT["lazy"] * M * bk * union.size
    else:
        strat = cfg.im2col
        if strat == "auto":
            strat = "slices"
        extract = COST_EXTRACT.get(strat, 12.0) * M * k_total
    gather = COST_GATHER * live * cfg.bm_rows * bk
    step = COST_STEP * counts["scheduled_steps"]
    occ_cost = COST_OCC * (M // cfg.sub_m) * kb
    return mac + extract + gather + step + occ_cost, counts


@torch.no_grad()
def _measure_config(cfg: ConvTileConfig, conv: PackedConv, x: torch.Tensor,
                    stride, padding, reps: int = 5) -> float:
    """Seconds a call of the layer takes at ``cfg`` on ``x``: CUDA events
    around ``reps`` calls on the card (after one call that builds the work
    list and the kernels), ``time.perf_counter`` on the CPU."""
    packed = conv.packed
    if cfg.bn is not None and cfg.bn != packed.bn:
        packed = pack_conv_filters(conv.w_dense, layout=conv.layout,
                                   bk=packed.bk, bn=cfg.bn,
                                   device=packed.vals.device)
    cache: dict = {}

    def call():
        return sparse_conv2d_nhwc(
            x, packed, conv.kh, conv.kw, conv.cout, stride=stride,
            padding=padding, sub_m=cfg.sub_m, bm_rows=cfg.bm_rows,
            im2col=cfg.im2col, layout=conv.layout, wl_cache=cache)[0]
    call()
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize(x.device)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return (time.perf_counter() - t0) / reps


def autotune_conv(conv: PackedConv, m_img: int, *, batch: int = 1,
                  candidates: Optional[Sequence[ConvTileConfig]] = None,
                  occ_blk: Optional[np.ndarray] = None,
                  measure: bool = False, x: Optional[torch.Tensor] = None,
                  stride=1, padding="SAME",
                  repack: bool = True) -> TuneRecord:
    """Tune one layer; caches the result on ``conv.tuned``.

    Candidates are scored in a fixed order and ties break toward the
    earlier one, so re-tuning an identical layer gives the identical
    :class:`TuneRecord`. When the winner's ``bn`` differs from the
    pack-time width and ``repack`` is set, the layer is re-packed at the
    tuned ``bn`` (same ``bk``, so the same bits) on the same device and its
    stale work-list cache is dropped."""
    m_img = int(m_img)
    cands = list(candidates) if candidates is not None else \
        candidate_configs(conv, m_img, batch=batch)
    if not cands:
        raise ValueError("no candidate configs")
    if measure and x is None:
        raise ValueError("measure=True needs a calibration input x")
    table: List[Tuple[ConvTileConfig, float, Dict[str, int]]] = []
    for cfg in cands:
        cost, counts = score_config(cfg, conv, m_img, batch=batch,
                                    occ_blk=occ_blk)
        if measure:
            cost = _measure_config(cfg, conv, x, stride, padding)
        table.append((cfg, cost, counts))
    best = min(range(len(table)), key=lambda i: table[i][1])
    cfg, cost, counts = table[best]
    rec = TuneRecord(cfg, float(cost), counts, table, m_img, batch,
                     measured=measure)
    if repack and cfg.bn is not None and cfg.bn != conv.packed.bn:
        conv.packed = pack_conv_filters(conv.w_dense, layout=conv.layout,
                                        bk=conv.packed.bk, bn=cfg.bn,
                                        device=conv.packed.vals.device)
        conv.wl_cache.clear()
    conv.tuned = rec
    return rec


def autotune_model(model, image_size: Optional[int] = None, *,
                   batch: int = 1, measure: bool = False,
                   x: Optional[torch.Tensor] = None) -> Dict[int, TuneRecord]:
    """Walk a :class:`~repro_torch.vision.model.VisionModel`'s layer
    geometry and tune every conv (with ``measure``, on ``x`` carried through
    the layers at their default config); clears the model's compiled-forward
    cache so that the next ``compile_forward`` runs the tuned configs.
    A graph (a ResNet's shortcuts) raises ``ValueError``: the walk carries
    one map from layer to layer."""
    from repro_torch.vision.model import (max_pool, pooled_size,
                                          require_chain)
    require_chain(model, "autotune_model")
    size = image_size if image_size is not None else model.input_size
    H = W = size
    records: Dict[int, TuneRecord] = {}
    xi = x
    for i, layer in enumerate(model.layers):
        c = layer.conv
        oh, ow = conv_out_size(H, W, c.kh, c.kw, layer.stride, layer.padding)
        records[i] = autotune_conv(
            c, oh * ow, batch=batch, measure=measure, x=xi,
            stride=layer.stride, padding=layer.padding)
        H, W = pooled_size(oh, ow, layer.pool_after)
        if measure and xi is not None:
            with torch.no_grad():
                xi, _ = sparse_conv2d_nhwc(
                    xi, c.packed, c.kh, c.kw, c.cout, stride=layer.stride,
                    padding=layer.padding, layout=c.layout,
                    wl_cache=c.wl_cache)
                if layer.pool_after is not None:
                    xi = max_pool(xi, *layer.pool_after)
    model._fwd_cache.clear()
    return records
