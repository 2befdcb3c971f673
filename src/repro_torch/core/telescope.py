"""Telescoping request combining over a kernel schedule (§3.2).

Copy of the part of ``repro.core.telescope`` the conv path reports: the
telescoping combiner and :func:`combine_schedule_requests`, which runs it
over a serialized work list's per-step chunk ids.
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
