"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
the last ``TRACE_S`` seconds of the measured window, its events kept in
memory and reduced here, after the window, to a summary the per-layer
metrics read. (A whole 51 s window can hold a million events, and
reducing them outlasts a run's time limit; stopping the profiler inside
the window stalls the loop while it reduces.)

Kernel names are the program's: K1, the work-list walker of
``csrc/walk.cu``, launches ``tile_kernel`` (its tile mode) and
``walk_kernel`` / ``walk_pair_kernel`` (its grid mode); pooling runs
PyTorch's ``max_pool`` kernels; copies between host and card are the
profiler's ``Memcpy`` and ``Memset`` records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "traced"
TRACE_S = 10.0
K1_NAMES = ("tile_kernel", "walk_kernel", "walk_pair_kernel")
_NAME_CHARS = 160

Interval = Tuple[str, float, float]        # (name, start s, end s)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_NAMES)


def is_pool(name: str) -> bool:
    return "max_pool" in name


def traced(run, kind: str) -> Optional["TraceSummary"]:
    """The run's trace when it is of a ``kind`` loop and saw the card
    working, else None (nothing for a metric to read)."""
    t = run.trace
    if run.kind != kind or t is None or not t.device or t.window_s <= 0:
        return None
    return t


def union_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


@dataclasses.dataclass
class TraceSummary:
    """Device and host events of the traced window, in seconds from its
    start, each clipped to it."""
    window_s: float
    device: List[Interval]
    host: List[Interval]

    @property
    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device])

    def device_s(self, keep) -> float:
        """Summed device seconds of the events whose name ``keep`` takes."""
        return float(sum(e - s for n, s, e in self.device if keep(n)))

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:_NAME_CHARS], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device seconds by what the host was doing: each gap goes to
        the innermost host event around its middle."""
        idle = gaps([(s, e) for _, s, e in self.device], 0.0, self.window_s)
        if not idle:
            return []
        names = [n for n, _, _ in self.host]
        hs = np.array([s for _, s, _ in self.host])
        he = np.array([e for _, _, e in self.host])
        by: Dict[str, float] = {}
        for s, e in idle:
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if inside.size:
                i = inside[np.argmin(he[inside] - hs[inside])]
                name = names[i]
            else:
                name = "(no host event)"
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n[:_NAME_CHARS], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Stretch:
    """Starts ``tracer`` (if any) for the last ``TRACE_S`` of the window:
    the loop calls :meth:`at` before each step with the seconds since the
    window began and the number of steps so far, and :meth:`finish` once
    the loop has ended, so the trace is reduced outside the window.
    ``steps`` is then
    the slice of the window's steps that ran under the profiler,
    ``started_at`` the second of the window it started at, and ``summary``
    the trace."""

    def __init__(self, tracer: Optional["Tracer"], seconds: float):
        self.tracer = tracer
        self.start_s = max(0.0, seconds - TRACE_S)
        self.first: Optional[int] = None
        self.started_at: Optional[float] = None
        self.steps = slice(0, 0)
        self.summary: Optional[TraceSummary] = None
        self._span = None

    def at(self, elapsed: float, n_steps: int) -> None:
        if (self.tracer is not None and self.first is None
                and elapsed >= self.start_s):
            self.tracer.start()
            self._span = span(WINDOW_SPAN)
            self._span.__enter__()
            self.first = n_steps
            self.started_at = elapsed

    def finish(self, n_steps: int) -> None:
        if self.first is None:
            return
        self._span.__exit__(None, None, None)
        self.summary = self.tracer.stop()
        self.steps = slice(self.first, n_steps)


def span(name: str):
    """A harness span: a host range in the trace, mirrored on the device's
    timeline as an annotation."""
    return torch.profiler.record_function(name)


class Tracer:
    """``torch.profiler`` around the traced stretch; :meth:`warm` pays
    CUPTI's set-up on one call before the window, outside it."""

    def __init__(self):
        self._prof = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self, fn) -> None:
        with self._profile():
            fn()

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.start()

    def stop(self) -> Optional[TraceSummary]:
        prof, self._prof = self._prof, None
        prof.stop()
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        dev, host, window = [], [], None
        for ev in events:
            s = ev.start_ns()
            e = s + ev.duration_ns()
            name = ev.name()
            if ev.device_type() == cuda:
                # the harness's spans are mirrored on the device's
                # timeline as annotations: they are no device work
                if not (name.startswith(SPAN_PREFIX)
                        or getattr(ev, "is_user_annotation", bool)()):
                    dev.append((name, s, e))
            else:
                host.append((name, s, e))
                if name == WINDOW_SPAN:
                    window = (s, e)
        if window is None:
            return None
        w0, w1 = window

        def clip(evs):
            return [(n, (max(s, w0) - w0) * 1e-9, (min(e, w1) - w0) * 1e-9)
                    for n, s, e in evs if e > w0 and s < w1]
        return TraceSummary((w1 - w0) * 1e-9, clip(dev),
                            [h for h in clip(host) if h[0] != WINDOW_SPAN])
