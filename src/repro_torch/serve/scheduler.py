"""Continuous-batching scheduler: barrier-free slot management over the
per-slot-position decode engine (port of ``repro.serve.scheduler``).

* **No global barrier** — every slot holds a request at its own position
  (``slot_pos``); the decode step takes the whole position vector, so a
  late joiner never decodes (or writes KV) at another slot's position.
* **Round-robin lane assignment** (§3.3.2) — free slots are scanned in an
  order rotated by :func:`repro_torch.core.balance.round_robin_permutation`.
* **Colored buffers** — admission rebuilds the slot's cache lane from
  zeros (:func:`repro_torch.serve.engine.prefill_lane`, written over the
  slot's lane by :func:`~repro_torch.serve.engine.write_lane`).

The scheduler is host bookkeeping; the math runs in the engine functions
on the params' device. By default (``compiled=True``) each decode step
replays the captured step (:class:`~repro_torch.serve.engine.
GraphedServeStep`, one graph for the scheduler's width), each admission
the captured admission (:class:`~repro_torch.serve.engine.GraphedAdmit`,
one graph per prompt length, the slot a device tensor) and the FFN probe
its captured form (:class:`~repro_torch.serve.engine.GraphedFfnStats`),
all three on the scheduler's cache as their static buffer; the slot table
goes to the card in one packed copy a step. On either path the scheduler
writes admissions and lane resets into its cache in place.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.balance import round_robin_permutation
from repro_torch.models import model as M
from repro_torch import graphs
from repro_torch.serve.engine import (GraphedAdmit, GraphedFfnStats,
                                      GraphedServeStep, make_ffn_stats_fn,
                                      make_serve_step, prefill_lane,
                                      write_lane)
from repro_torch.tree import leaves


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is the scheduler step at which it
    becomes visible (staggered arrivals exercise late joining)."""
    rid: int
    prompt: np.ndarray          # [S] int token ids
    max_new: int
    arrival: int = 0


@dataclasses.dataclass
class ServeStats:
    engine_steps: int = 0
    prefills: int = 0
    decode_lane_steps: int = 0   # lanes that did real work
    idle_lane_steps: int = 0     # lanes parked (done/free) during a step
    tokens: int = 0
    wall_s: float = 0.0

    @property
    def slot_utilization(self) -> float:
        total = self.decode_lane_steps + self.idle_lane_steps
        return self.decode_lane_steps / total if total else 0.0

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0


class Scheduler:
    """Request queue + slot table driving the barrier-free engine on the
    device of ``params``.

    ``num_slots`` is the fixed batch width; requests beyond it queue.
    ``max_len`` bounds prompt_len + max_new per request (one cache row per
    position). ``verify_artifacts`` (on by default) verifies the packed
    sparse-FFN leaves at construction, before any launch. ``compiled`` (on
    by default, as the reference jits its step, admission and probe)
    replays the captured decode step, admission and FFN probe on the card;
    ``compiled=False`` runs the eager functions, for the comparison runs.
    """

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 verify_artifacts: bool = True, compiled: bool = True):
        if cfg.encoder_layers:
            raise ValueError("the scheduler serves decoder-only models")
        # admission gate: when the checkpoint carries packed sparse-FFN
        # leaves, prove them well-formed before the first kernel indexes
        # them (value checks run on the leaves' device); False opts out.
        if verify_artifacts and getattr(cfg, "sparse_ffn", False):
            from repro_torch.analysis import (raise_on_errors,
                                              verify_param_leaves)
            raise_on_errors(verify_param_leaves(params, d_model=cfg.d_model),
                            "Scheduler admission")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.greedy = greedy
        self.compiled = compiled
        if compiled:
            self._step_fn = GraphedServeStep(cfg, greedy)
            self._admit_fn = GraphedAdmit(cfg, max_len, greedy)
            self._stats_fn = GraphedFfnStats(cfg)
        else:
            eager = make_serve_step(cfg, greedy)
            self._step_fn = lambda params, cache, *slots: eager(
                params, cache, *map(self._dev, slots))
            self._admit_fn = self._admit_eager
            probe = make_ffn_stats_fn(cfg)
            self._stats_fn = lambda params, cache, *slots: probe(
                params, cache, *map(self._dev, slots))
        self.cache = M.init_cache(cfg, num_slots, max_len, device=self.device)
        # slot table
        self.slot_req = np.full(num_slots, -1, np.int64)
        self.slot_pos = np.zeros(num_slots, np.int64)
        self.slot_tok = np.zeros(num_slots, np.int64)
        self._rr = 0                     # round-robin admission rotation
        self.clock = 0                   # scheduler step counter
        self.queue: Deque[Request] = deque()
        self._running: Dict[int, Request] = {}
        self.produced: Dict[int, List[int]] = {}
        self.done_at: Dict[int, int] = {}   # rid -> completion clock tick
        self.stats = ServeStats()
        self.ffn_probe: Optional[Dict[str, float]] = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def captured_graphs(self) -> List[graphs.CapturedGraph]:
        """The captured graphs of the decode step, admission and probe
        (none when ``compiled=False``)."""
        if not self.compiled:
            return []
        return [g for fn in (self._step_fn, self._admit_fn, self._stats_fn)
                for g in fn.graphs.values()]

    def _admit_eager(self, params, cache, prompt: np.ndarray, slot: int):
        tok, lane = prefill_lane(params, self.cfg, self.max_len,
                                 self._dev(prompt)[None], self.greedy)
        return tok, write_lane(cache, lane, slot)

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1 "
                             "(admission always yields the prefill token)")
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds max_len {self.max_len}")
        self.queue.append(req)

    @property
    def idle(self) -> bool:
        return not self.queue and not self._running

    # -- slot lifecycle ----------------------------------------------------
    def _next_arrived(self) -> Optional[Request]:
        """Pop the earliest-submitted request whose arrival has passed (a
        late-arriving head does not starve an arrived request behind it)."""
        for i, req in enumerate(self.queue):
            if req.arrival <= self.clock:
                del self.queue[i]
                return req
        return None

    def _admit_ready(self) -> None:
        """Admit queued, arrived requests into free slots, rotating the scan
        order across lanes (BARISTA round-robin)."""
        if not self.queue:
            return
        for s in round_robin_permutation(self.num_slots, self._rr):
            if self.slot_req[s] >= 0:
                continue
            req = self._next_arrived()
            if req is None:
                break
            tok, self.cache = self._admit_fn(
                self.params, self.cache, np.asarray(req.prompt, np.int64),
                int(s))
            first = int(tok[0, 0])
            self.stats.prefills += 1
            self.stats.tokens += 1
            self._rr += 1
            self.produced[req.rid] = [first]
            if req.max_new <= 1:
                self.done_at[req.rid] = self.clock
                continue                 # done at prefill; slot stays free
            self.slot_req[s] = req.rid
            self.slot_pos[s] = len(req.prompt)
            self.slot_tok[s] = first
            self._running[req.rid] = req

    def _retire(self, s: int) -> None:
        rid = int(self.slot_req[s])
        self.done_at[rid] = self.clock
        del self._running[rid]
        self.slot_req[s] = -1
        self.slot_pos[s] = 0
        self.slot_tok[s] = 0

    def probe_ffn_stats(self) -> Optional[Dict[str, float]]:
        """Instrumented decode step over the current live slots (read-only).

        Returns the sparse-FFN tile-MAC counts summed across blocks —
        ``executed`` (two-sided), ``weight_tile_macs`` (one-sided),
        ``dense_tile_macs`` — with ``skipped_frac`` (activation-side skips
        among stored-chunk MACs) and ``executed_frac`` (vs dense), and under
        ``schedule`` the work-list counters of the same launches with
        ``compaction_factor`` (predicated-grid steps over scheduled steps,
        also flat as ``decode_compaction``). ``None`` when no slot is live
        or the params carry no sparse leaves.
        """
        active = self.slot_req >= 0
        if not active.any():
            return None
        stats = self._stats_fn(self.params, self.cache,
                               self.slot_tok[:, None], self.slot_pos, active)
        # read after the replay (the captured probe keeps them on the card)
        stats = {k: float(v) for k, v in stats.items()}
        if stats["dense_tile_macs"] == 0:
            return None                  # dense params: nothing to skip
        stats["skipped_frac"] = 1.0 - stats["executed"] / max(
            stats["weight_tile_macs"], 1.0)
        stats["executed_frac"] = stats["executed"] / stats["dense_tile_macs"]
        sched_keys = ("scheduled_steps", "live_chunk_steps",
                      "flush_only_steps", "dense_grid_steps",
                      "predicated_grid_steps")
        if all(k in stats for k in sched_keys):
            sched = {k: stats.pop(k) for k in sched_keys}
            sched["compaction_factor"] = (
                sched["predicated_grid_steps"]
                / max(sched["scheduled_steps"], 1.0))
            stats["schedule"] = sched
            stats["decode_compaction"] = sched["compaction_factor"]
        return stats

    # -- engine ------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler tick: admissions, then one batched decode step over
        the live slots (done/free lanes masked). Returns False when idle."""
        self._admit_ready()
        active = self.slot_req >= 0
        if not active.any():
            if self.queue:               # waiting on future arrivals
                self.clock += 1
                return True
            return False
        nxt, self.cache = self._step_fn(self.params, self.cache,
                                        self.slot_tok[:, None],
                                        self.slot_pos, active)
        nxt = nxt.cpu().numpy()
        self.stats.engine_steps += 1
        self.stats.decode_lane_steps += int(active.sum())
        self.stats.idle_lane_steps += int((~active).sum())
        freed = np.zeros(self.num_slots, bool)
        for s in np.nonzero(active)[0]:
            rid = int(self.slot_req[s])
            tok = int(nxt[s, 0])
            self.produced[rid].append(tok)
            self.stats.tokens += 1
            self.slot_pos[s] += 1
            self.slot_tok[s] = tok
            if len(self.produced[rid]) >= self._running[rid].max_new:
                self._retire(s)
                freed[s] = True
        if freed.any():
            # lane hygiene: zero freed lanes now; admission re-zeroes anyway
            keep = self._dev(~freed)
            for a in leaves(self.cache):
                a.mul_(keep.reshape((-1,) + (1,) * (a.ndim - 1)).to(a.dtype))
        self.clock += 1
        return True

    def run(self, requests: Optional[List[Request]] = None, *,
            probe_ffn: bool = False) -> Dict[int, List[int]]:
        """Serve ``requests`` (plus anything already queued) to completion;
        returns {rid: generated tokens} and fills ``self.stats``.

        ``probe_ffn`` runs :meth:`probe_ffn_stats` once on the first live
        batch into ``self.ffn_probe``; its time is kept out of the serving
        wall clock.
        """
        for r in requests or []:
            self.submit(r)
        if probe_ffn:
            self.ffn_probe = None
        t0 = time.perf_counter()
        while self.step():
            if probe_ffn and self.ffn_probe is None:
                p0 = time.perf_counter()
                self.ffn_probe = self.probe_ffn_stats()
                t0 += time.perf_counter() - p0
        self.stats.wall_s += time.perf_counter() - t0
        return self.produced
