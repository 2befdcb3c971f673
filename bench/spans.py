"""The program's own spans in a traced run: the phases of
``VisionEngine.step`` and of ``CapturedGraph``'s replay, which
``repro_torch.obs`` records as host ranges on the clock of the card's
records while the profiler runs. ``TraceSummary.host`` holds them, each
clipped to the stretch. A program without them (no ``engine.step`` span in
the trace) gives the readers nothing to read.
"""
from __future__ import annotations

import bisect
from typing import Optional, Sequence

from bench.trace import TraceSummary, gaps, traced, union_s

STEP = "engine.step"
# the engine's own host work in a step, and the graph's pageable batch copy
ENGINE_HOST = ("engine.admit", "engine.assemble", "engine.retire")
COPY_IN = ("graph.copy_in",)


def engine_trace(run) -> Optional[TraceSummary]:
    """The closed loop's trace when it holds an ``engine.step`` span."""
    t = traced(run, "closed")
    if t is None or not any(n == STEP for n, _, _ in t.host):
        return None
    return t


def per_step_ms(run, names: Sequence[str]) -> Optional[float]:
    """Milliseconds per whole step of the spans named ``names`` that lie
    inside the whole steps: the ``engine.step`` spans that neither edge of
    the stretch clips."""
    t = engine_trace(run)
    if t is None:
        return None
    steps = sorted((s, e) for n, s, e in t.host
                   if n == STEP and s > 0.0 and e < t.window_s)
    if not steps:
        return None
    starts = [s for s, _ in steps]
    total = 0.0
    for n, s, e in t.host:
        if n in names:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= steps[i][1]:
                total += e - s
    return total / len(steps) * 1e3


def idle_overlap_s(t: TraceSummary, names: Sequence[str]) -> float:
    """Seconds of the stretch in which nothing runs on the card and the
    host is inside a span named ``names``: the measure of the
    intersection, |idle| + |host| - |idle or host|."""
    idle = gaps([(s, e) for _, s, e in t.device], 0.0, t.window_s)
    host = [(s, e) for n, s, e in t.host if n in names]
    return union_s(idle) + union_s(host) - union_s(idle + host)
