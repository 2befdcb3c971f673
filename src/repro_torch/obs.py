"""Program spans: named host ranges on the clock of ``torch.profiler``.

``with span("engine.assemble"): ...`` marks a phase of the program. While
a ``torch.profiler`` session records, the span is a
``torch.profiler.record_function`` range: a host range on Kineto's clock,
the one the card's CUPTI records use, so a trace puts the program's
phases and the card's kernels and copies on one axis, and ranges nested
on one thread hold their parent. Otherwise it is one shared no-op
context: no clock read, no allocation, no name formatted
(``record_function`` costs several microseconds a call even with no
profiler running, :func:`span` a fraction of one).

The recording profiler keeps the spans in memory and writes them out
(``export_chrome_trace``, or the benchmark's reduction of its events);
there is no store, exporter or switch of this module's own. Names are
constant strings, ``<layer>.<what>``: ``engine.*`` (``VisionEngine``),
``server.*`` (``VisionServer``), ``graph.*`` (``CapturedGraph``),
``conv.*`` (the sparse conv layer).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a host range while a profiler
    records, and the shared no-op otherwise."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
