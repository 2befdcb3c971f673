"""CUDA graphs: the port's counterpart of the reference's ``jax.jit``.

The reference compiles each path once per static shape: the decode step,
the prefill, slot admission and the FFN probe (``jitted_serve_step``,
``jitted_prefill``, ``jitted_admit``, ``jitted_ffn_stats``,
``repro.serve.engine``), the train step (``repro.train.loop``, with
donation) and the whole VGG16 forward
(``repro.vision.model.compile_forward``). Here a
:class:`CapturedGraph` captures one callable, the *body*, with
``torch.cuda.graph`` into a private memory pool, and replays it after
copying new inputs into its static input buffers.

* **Static inputs.** The first call copies each input into a buffer of
  the graph's own, so the caller's tensors are never written; an input
  the caller marks as adopted (``adopt``: the decode step's cache, the
  train step's params and optimizer state) is taken as the buffer
  itself, which the graph reads and writes. Later calls copy each input
  into its buffer (``copy_``, from the host or the card); a call given
  the buffer itself copies nothing. The buffers are
  never reallocated: the graph bakes in their addresses, as K1's tensor
  maps bake in its input's.
* **Warm-up, then capture.** The first call runs the body eagerly. That
  builds the kernels' ``.so`` files, the work lists and their device
  copies, none of which may happen inside a capture, and it is the call's
  real result (a decode step applied once to live state, not twice). The
  graph is captured right after it (capture runs nothing) and replayed
  from the second call on.
* **Launch counts.** While it is captured, the kernel wrappers tally their
  launches (and their :class:`~repro_torch.kernels._cuda.LaunchCounter`
  counts, such as the walker's tap-slab launches) on the graph
  (:func:`repro_torch.kernels._cuda.capture_tally`) and count nothing;
  each replay adds the tally, so a counter reads what the eager calls
  would have launched.
* **No silent fallback.** A body that makes a call CUDA cannot capture (a
  host read such as ``.item()``, ``.cpu()`` or ``.tolist()``, a
  synchronisation, a host schedule build) raises
  :class:`GraphCaptureError` naming the graph and the call, and so does
  every later call of that graph; nothing runs eagerly in its place. The
  port's lint flags host reads in the bodies statically
  (``GRAPH-HOST-READ``): mark each body with :func:`captured`.
* **Random numbers.** A body that draws from a ``torch.Generator`` of the
  card's (a sampled decode step) names it as ``generator``: the graph
  registers it (``CUDAGraph.register_generator_state``), so each replay
  draws from the generator's current Philox offset and advances it by
  what one eager call would, and a replayed run draws the eager run's
  numbers.
* **Spans.** Under a recording profiler a replay's input copies, the
  replay and a capture are ``graph.copy_in``, ``graph.replay`` and
  ``graph.capture`` spans (:mod:`repro_torch.obs`).
* **The CPU.** There is nothing to capture on the CPU: the body is called
  directly on the inputs given, as the kernels' plain versions are.

A replay returns the graph's static output tensors, which the next replay
overwrites. A graph keeps alive what its body closes over and what it is
given to ``keep`` (the tensors whose addresses it bakes in); its owner
decides how long it lives.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.kernels import _cuda
from repro_torch.obs import span
from repro_torch.tree import leaves, map_tree


class GraphCaptureError(RuntimeError):
    """A body made a call that a CUDA graph cannot capture."""


def captured(body: Callable) -> Callable:
    """Mark ``body`` as a function that :class:`CapturedGraph` captures
    (the port's lint reads the mark; nothing changes at run time)."""
    return body


class CapturedGraph:
    """``body(*inputs)`` captured once on ``device`` and replayed.

    ``inputs`` are tensors or nested dicts, lists and tuples of them, the
    same structure, shapes and types at every call. ``adopt`` lists the
    positions of the inputs the graph takes as its buffers at the first
    call (the caller's tensors, then read and written by every replay);
    every other input is copied into a buffer of the graph's. ``keep``
    holds objects alive as long as the graph (the params whose addresses
    it bakes in). ``generator`` is the ``torch.Generator`` the body draws
    from, if any. ``name`` names the graph in errors. ``replays`` counts
    the replays, ``capture_s`` is the
    capture's host time, ``pool_bytes`` the memory the capture reserved on
    the device (the graph's private pool: its intermediates and outputs)
    and ``tally`` the launches one replay makes, by counter.
    """

    def __init__(self, body: Callable, device, name: str,
                 adopt: Sequence[int] = (), keep: Any = None,
                 generator: Optional[torch.Generator] = None):
        self.body = body
        self.device = torch.device(device)
        self.name = name
        self.adopt = frozenset(adopt)
        self.keep = keep
        self.generator = generator
        self.static: Optional[tuple] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.error: Optional[GraphCaptureError] = None
        self.outputs: Any = None
        self.tally: Dict[_cuda.LaunchCounter, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, copy=True)

    def _adopt(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.device == self.device else t.to(self.device)

    def __call__(self, *inputs):
        if self.device.type != "cuda":
            return self.body(*inputs)
        if self.error is not None:
            raise self.error
        if self.static is None:
            self.static = tuple(
                map_tree(self._adopt if i in self.adopt else self._buffer, x)
                for i, x in enumerate(inputs))
            out = self.body(*self.static)          # the eager warm-up
            with span("graph.capture"):
                self._capture()
            return out
        static, given = leaves(self.static), leaves(inputs)
        if len(static) != len(given):
            raise ValueError(f"{self.name}: {len(given)} input tensors, the "
                             f"graph was captured with {len(static)}")
        with span("graph.copy_in"):
            for s, x in zip(static, given):
                if x is s:
                    continue
                if x.shape != s.shape or x.dtype != s.dtype:
                    raise ValueError(
                        f"{self.name}: an input of {tuple(x.shape)} "
                        f"{x.dtype} where the graph has {tuple(s.shape)} "
                        f"{s.dtype}")
                s.copy_(x)
        with span("graph.replay"):
            self.graph.replay()
        self.replays += 1
        for counter, n in self.tally.items():
            counter.launches += n
        return self.outputs

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        tally: Dict[_cuda.LaunchCounter, int] = {}
        try:
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            with torch.cuda.device(self.device), \
                    _cuda.capture_tally(tally), torch.cuda.graph(graph):
                # after the context emptied the allocator's cache
                reserved = torch.cuda.memory_reserved(self.device)
                out = self.body(*self.static)
        except Exception as e:
            inner = e.__context__
            why = f"{type(e).__name__}: {e}" + (
                f" (after {type(inner).__name__}: {inner})" if inner else "")
            self.error = GraphCaptureError(
                f"{self.name}: the body made a call a CUDA graph cannot "
                f"capture: {why}. Host reads (.item(), .cpu(), .tolist(), "
                f".numpy(), int()/float()/bool() of a tensor), "
                f"synchronisations, host-built tensors and host schedule "
                f"builds stay out of captured bodies")
            raise self.error from e
        self.graph, self.outputs, self.tally = graph, out, tally
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

