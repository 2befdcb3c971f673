"""Chunk-aligned structured pruning for the conv packing chain (numpy copy of
``repro.sparsity.structured``).

The unstructured magnitude pruner (:func:`repro_torch.core.sparse.
prune_by_magnitude`) hits the target *scalar* density but scatters the
survivors: at 0.33 scalar density every (chunk x block) tile of the
matrixized filters still holds a non-zero, so the packed chunk maps are
full (``filter_chunk_density == 1.0``) and the telescoped work list has
nothing to compact.  This module prunes at the granularity the kernel can
actually skip — whole ``(bk, bn)`` tiles of the matrixized ``[K, N]``
filters — so dead chunks exist *by construction* (the Sense / GrateTile
co-design argument, and SNIPPETS.md §1's MCBBS pattern):

* **tap-major layout** — filters are matrixized as the plain
  ``w.reshape(kh*kw*cin, cout)`` (K index = ``tap * cin + channel``)
  instead of the channel-major transpose, so that when ``cin % bk == 0``
  every K-chunk lies inside a single filter tap.  A live chunk is then one
  ``(tap, channel-group)`` slab of the input, which a lazy im2col path
  can materialize without ever building the full K-fold patch matrix.
* **bank-balanced selection** — each N-block ("bank" in MCBBS terms) keeps
  its top-energy tiles, with per-bank quotas differing by at most one, so
  ``max_nz`` is tight and every bank's work list has near-identical length
  (the load balance the unstructured path got from ``greedy_balance``,
  recovered here at tile granularity without scrambling tile alignment).
* **micro-range clustering** — within a bank the K-chunks are split into a
  few contiguous micro-ranges and the quota is spread across them
  (largest-remainder), bounding how far apart consecutive live chunk
  indices can sit — MCBBS's fetch-locality constraint in software.

Kept tiles are untouched (fully dense at the chunk-map level); killed
tiles are exact zeros.  Scalar density therefore equals the live-tile
fraction, which the quota arithmetic pins to the target within one tile
per bank — the "equal accuracy-proxy density" contract the property tests
check against the unstructured pruner.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import bitmask as bm

#: below this input-channel count the matrixized K axis is too short for
#: chunk-granular pruning (a single chunk spans several taps); such layers
#: fall back to unstructured pruning in the channel-major layout.
MIN_TAP_CIN = 16


def choose_chunk_layout(shape: Tuple[int, int, int, int],
                        chunk: int = bm.CHUNK) -> Tuple[str, int, int]:
    """Pick (layout, bk, bn) for a [kh, kw, cin, cout] filter tensor.

    ``layout="tap"`` (K index = tap*cin + c) with ``bk = chunk`` when the
    channel count divides into whole chunks, else ``bk = cin`` (one tap =
    a whole number of chunks either way).  Layers too narrow for that
    (the 3-channel stem) keep the channel-major layout with a K-rounded
    ``bk`` and are pruned unstructured.  ``bn`` divides ``cout`` exactly
    when ``cout <= chunk`` so no dead padding columns enter the GEMM.
    """
    kh, kw, cin, cout = shape
    bn = chunk if cout % chunk == 0 else min(cout, chunk)
    if cin >= MIN_TAP_CIN and (cin % chunk == 0 or cin <= chunk):
        bk = chunk if cin % chunk == 0 else cin
        return "tap", bk, bn
    # stem fallback: channel-major, one chunk just big enough for K
    k = kh * kw * cin
    bk = min(-(-k // 8) * 8, chunk)
    return "channel", bk, bn


@dataclasses.dataclass
class ChunkPruneInfo:
    """What the chunk-aligned pruner did to one layer (pack-time record)."""
    keep: np.ndarray              # bool [kb, nb] live-tile map
    bk: int
    bn: int
    quota: np.ndarray             # int [nb] live tiles per bank
    micro_ranges: int

    @property
    def live_fraction(self) -> float:
        return float(self.keep.mean())

    @property
    def dead_chunk_fraction(self) -> float:
        return 1.0 - self.live_fraction


def _bank_quotas(score: np.ndarray, target_total: int) -> np.ndarray:
    """Split ``target_total`` live tiles across banks, ±1 per bank
    (bank-balanced), extra tiles going to the highest-energy banks."""
    kb, nb = score.shape
    base, extra = divmod(target_total, nb)
    quota = np.full(nb, base, np.int64)
    if extra:
        order = np.argsort(-score.sum(axis=0), kind="stable")
        quota[order[:extra]] += 1
    return np.minimum(quota, kb)


def _range_quotas(scores: np.ndarray, bounds: np.ndarray,
                  quota: int) -> np.ndarray:
    """Largest-remainder split of one bank's quota across its micro-ranges
    (proportional to range length, score-greedy remainders)."""
    sizes = np.diff(bounds)
    exact = quota * sizes / sizes.sum()
    take = np.floor(exact).astype(np.int64)
    rem = quota - take.sum()
    if rem > 0:
        # prefer ranges whose best unused tile has the most energy
        resid = np.array([
            np.sort(scores[bounds[g]:bounds[g + 1]])[::-1][take[g]]
            if take[g] < sizes[g] else -np.inf
            for g in range(sizes.shape[0])])
        order = np.argsort(-(exact - take) - 1e-9 * np.arange(len(sizes)),
                           kind="stable")
        order = sorted(order, key=lambda g: (-(exact - take)[g], -resid[g]))
        for g in order:
            if rem == 0:
                break
            if take[g] < sizes[g]:
                take[g] += 1
                rem -= 1
    # spill any remainder (ranges saturated) greedily
    while rem > 0:
        for g in np.argsort(-sizes, kind="stable"):
            if take[g] < sizes[g]:
                take[g] += 1
                rem -= 1
                break
    return take


def prune_chunk_aligned(w: np.ndarray, density: float, *, bk: int, bn: int,
                        micro_ranges: int = 3
                        ) -> Tuple[np.ndarray, ChunkPruneInfo]:
    """Magnitude-prune [kh, kw, cin, cout] filters at (bk x bn) tile
    granularity in the tap-major matrixization.

    Keeps ``round(density * kb * nb)`` tiles overall, bank-balanced and
    micro-range clustered (see module docstring); surviving tiles are
    bitwise-untouched, killed tiles become exact zeros.  Returns the
    pruned tensor plus the :class:`ChunkPruneInfo` map the packer and the
    stats path reuse.
    """
    kh, kw, cin, cout = w.shape
    if cin % bk != 0:
        raise ValueError(f"tap-major chunks need cin % bk == 0, got "
                         f"cin={cin} bk={bk}")
    w = np.asarray(w, np.float32)
    K = kh * kw * cin
    wm = w.reshape(K, cout)
    pad_n = (-cout) % bn
    if pad_n:
        wm = np.pad(wm, ((0, 0), (0, pad_n)))
    kb, nb = K // bk, wm.shape[1] // bn
    tiles = wm.reshape(kb, bk, nb, bn)
    score = np.square(tiles).sum(axis=(1, 3))                 # [kb, nb] L2^2
    target_total = int(round(np.clip(density, 0.0, 1.0) * kb * nb))
    quota = _bank_quotas(score, target_total)

    g = max(1, min(micro_ranges, kb))
    bounds = np.linspace(0, kb, g + 1).astype(np.int64)
    keep = np.zeros((kb, nb), bool)
    for n in range(nb):
        take = _range_quotas(score[:, n], bounds, int(quota[n]))
        for r in range(g):
            lo, hi = int(bounds[r]), int(bounds[r + 1])
            if take[r] == 0:
                continue
            local = np.argsort(-score[lo:hi, n], kind="stable")[: take[r]]
            keep[lo + local, n] = True

    pruned = np.where(keep[:, None, :, None], tiles, 0.0)
    wp = pruned.reshape(K, nb * bn)[:, :cout].reshape(kh, kw, cin, cout)
    return wp, ChunkPruneInfo(keep, bk, bn, quota, g)


def bank_balance_permutation(keep: np.ndarray, bn: int,
                             cout: int, direction: int = 0) -> np.ndarray:
    """Inter-bank balance at *block* granularity.

    The unstructured chain balances per output channel, which would
    scramble tile columns across banks and destroy the chunk alignment.
    Here whole ``bn``-column banks are reordered by live-tile count (the
    GB-S density sort of :func:`repro_torch.core.balance.greedy_balance` lifted
    to banks, direction alternating per layer like the paper's two fixed
    permutations); with bank-balanced quotas the counts differ by at most
    one, so this is the identity whenever the quota split is exact.
    Returns a permutation of the ``cout`` axis (block-expanded, truncated
    to the real channels).
    """
    counts = keep.sum(axis=0)
    nb = counts.shape[0]
    if cout % bn != 0:
        # a padded last bank cannot move without re-cutting tile columns
        return np.arange(cout)
    order = np.argsort(counts, kind="stable")
    if direction % 2 == 1:
        order = order[::-1]
    if np.all(counts == counts[0]):
        order = np.arange(nb)                  # balanced already: identity
    perm = (order[:, None] * bn + np.arange(bn)[None, :]).reshape(-1)
    return perm[perm < cout]
