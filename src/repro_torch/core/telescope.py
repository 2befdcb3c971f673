"""Telescoping request combining & snarfing — bandwidth model (§3.2).

A numpy copy of ``repro.core.telescope``: the nodes of an IFGC request the
same input-map chunk at *about* the same time (a tapered arrival profile);
BARISTA combines telescoping numbers of requests (e.g. 48/12/2/1/1 of 64),
and requests arriving while a fetch is outstanding snarf its response. The
cycle simulator's buffer sensitivity (paper Fig. 11) reads
:func:`refetch_curve` and :func:`uncombined_fetches`; the conv path's
schedule counters read :func:`combine_schedule_requests`. Host float64
arithmetic on an explicit ``np.random.Generator``, in the reference's
order, so the results equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_TELESCOPE = (48, 12, 2, 1, 1)  # paper's example for 64 nodes


@dataclasses.dataclass
class CombineResult:
    fetches: float          # cache fetches actually issued (per chunk)
    stall_cycles: float     # total node-cycles spent waiting for combining
    combined: List[int]     # group sizes actually realized


def sample_arrivals(num_nodes: int, spread: float, rng: np.random.Generator,
                    taper: float = 2.0) -> np.ndarray:
    """Arrival times of the nodes' requests for one chunk: lognormal
    offsets (most nodes nearly in sync, a tail of stragglers) scaled to
    ``spread`` cycles (paper Fig. 5)."""
    base = rng.lognormal(mean=0.0, sigma=taper, size=num_nodes)
    base.sort()
    base = (base - base[0]) / max(base[-1] - base[0], 1e-9)
    return base * spread


def telescoping_combine(arrivals: np.ndarray, fetch_latency: float,
                        groups: Sequence[int] = DEFAULT_TELESCOPE) -> CombineResult:
    """Combine requests in telescoping group sizes; a request arriving
    within ``fetch_latency`` of an outstanding fetch snarfs its response."""
    arrivals = np.sort(np.asarray(arrivals, np.float64))
    n = arrivals.shape[0]
    g = np.asarray(groups, np.float64)
    g = np.maximum((g / g.sum() * n).round().astype(int), 1)
    while g.sum() > n:
        g[np.argmax(g)] -= 1
    while g.sum() < n:
        g[0] += 1

    fetches = 0
    stall = 0.0
    realized: List[int] = []
    i = 0
    outstanding_until = -np.inf
    for size in g:
        j = min(i + int(size), n)
        if i >= n:
            break
        first = arrivals[i]
        if first <= outstanding_until:
            realized[-1] += j - i
        else:
            fetches += 1
            outstanding_until = first + fetch_latency
            realized.append(j - i)
        stall += float(np.sum(arrivals[j - 1] - arrivals[i:j]))
        i = j
    return CombineResult(float(fetches), stall, realized)


def snarf_fetches(num_nodes: int, buffer_free_prob: float,
                  rng: np.random.Generator, rounds: int = 8) -> float:
    """Filter snarfing: one node requests, peers with a free buffer snarf,
    the rest re-request among themselves; returns the fetches per filter
    chunk (stragglers after ``rounds`` fetch individually)."""
    remaining = num_nodes
    fetches = 0.0
    for _ in range(rounds):
        if remaining <= 0:
            break
        fetches += 1
        served = 1 + rng.binomial(remaining - 1, buffer_free_prob)
        remaining -= served
    return fetches + max(remaining, 0)


def refetch_curve(num_nodes: int, buffer_depths: Sequence[int],
                  spread: float, fetch_latency: float,
                  seed: int = 0, trials: int = 64) -> List[float]:
    """Average fetches per chunk against per-node buffer depth (Fig. 11):
    a deeper buffer shrinks the arrival spread the combiner sees by
    ``1 / depth``."""
    rng = np.random.default_rng(seed)
    out = []
    for depth in buffer_depths:
        eff_spread = spread / max(depth, 1)
        f = 0.0
        for _ in range(trials):
            arr = sample_arrivals(num_nodes, eff_spread, rng)
            f += telescoping_combine(arr, fetch_latency).fetches
        out.append(f / trials)
    return out


def combine_schedule_requests(chunk_ids: Sequence[int],
                              fetch_latency: Optional[float] = None,
                              groups: Sequence[int] = DEFAULT_TELESCOPE
                              ) -> dict:
    """Request-combining model applied to a kernel schedule.

    ``chunk_ids`` is the work list's per-step input-chunk id (-1 =
    flush-only, no request); each step requests its chunk at time = its
    schedule position. ``fetch_latency`` is in steps (default: total reads
    over distinct chunks). Returns ``requests``, ``fetches`` and
    ``combine_factor`` (requests per fetch).
    """
    ids = np.asarray(chunk_ids)
    times = np.nonzero(ids >= 0)[0].astype(np.float64)
    ids = ids[ids >= 0]
    if ids.size == 0:
        return {"requests": 0, "fetches": 0.0, "combine_factor": 1.0}
    uniq = np.unique(ids)
    if fetch_latency is None:
        fetch_latency = float(ids.size) / max(len(uniq), 1)
    fetches = 0.0
    for u in uniq:
        fetches += telescoping_combine(times[ids == u], fetch_latency,
                                       groups=groups).fetches
    requests = int(ids.size)
    return {"requests": requests, "fetches": float(fetches),
            "combine_factor": requests / max(fetches, 1e-9)}


def combine_cross_requests(chunk_ids: Sequence[int],
                           image_of: Sequence[int],
                           fetch_latency: Optional[float] = None,
                           groups: Sequence[int] = DEFAULT_TELESCOPE
                           ) -> dict:
    """The combining model across the requests of a batch.

    ``chunk_ids`` is the batched schedule's per-step weight-chunk id (-1 =
    flush-only) and ``image_of`` each step's image. The per-image baseline
    combines each image's requests alone (sequential serving); the batched
    pass combines the interleaved stream. Returns ``requests``,
    ``per_image_fetches``, ``fetches`` (batched), ``combine_factor``
    (per-image over batched; 1.0 at batch 1) and ``total_combine_factor``
    (requests per batched fetch).
    """
    ids = np.asarray(chunk_ids)
    imgs = np.asarray(image_of)
    if ids.shape != imgs.shape:
        raise ValueError(f"chunk_ids {ids.shape} and image_of {imgs.shape} "
                         f"differ in shape")
    times = np.nonzero(ids >= 0)[0].astype(np.float64)
    imgs = imgs[ids >= 0]
    ids = ids[ids >= 0]
    if ids.size == 0:
        return {"requests": 0, "per_image_fetches": 0.0, "fetches": 0.0,
                "combine_factor": 1.0, "total_combine_factor": 1.0}
    if fetch_latency is None:
        fetch_latency = float(ids.size) / max(len(np.unique(ids)), 1)
    batched = 0.0
    per_image = 0.0
    for u in np.unique(ids):
        sel = ids == u
        batched += telescoping_combine(times[sel], fetch_latency,
                                       groups=groups).fetches
        for im in np.unique(imgs[sel]):
            per_image += telescoping_combine(
                times[sel & (imgs == im)], fetch_latency,
                groups=groups).fetches
    requests = int(ids.size)
    return {"requests": requests,
            "per_image_fetches": float(per_image),
            "fetches": float(batched),
            "combine_factor": per_image / max(batched, 1e-9),
            "total_combine_factor": requests / max(batched, 1e-9)}


def uncombined_fetches(num_nodes: int, spread: float, fetch_latency: float,
                       rng: np.random.Generator, trials: int = 64) -> float:
    """No-opts baseline: every request past the in-flight window refetches."""
    total = 0.0
    for _ in range(trials):
        arr = np.sort(sample_arrivals(num_nodes, spread, rng))
        outstanding_until = -np.inf
        f = 0
        for a in arr:
            if a > outstanding_until:
                f += 1
                outstanding_until = a + fetch_latency
        total += f
    return total / trials
