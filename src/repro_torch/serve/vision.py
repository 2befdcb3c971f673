"""Multi-tenant vision serving: SLA-aware admission over shape-bucketed
sparse CNN forwards with cross-request telescoped scheduling (port of
``repro.serve.vision``).

The open-loop counterpart of :class:`repro_torch.vision.engine.VisionEngine`:

* **Wall-clock queue** — requests carry ``arrival_s`` / ``deadline_s``
  (seconds from the start of the run); the server is event-driven and
  idles until the next arrival.
* **Shape buckets** — a few canonical input sizes, each run as one
  ``num_slots``-wide batch of the compiled forward; a request routes to the
  smallest bucket that holds it (zero-pad up, exact; downscale only past
  the largest bucket). Each bucket is warmed up front, its first call
  charged to ``compile_s``.
* **SLA-aware admission** — each step admits the bucket batch with the
  most ready images per estimated step cost among the buckets whose choice
  busts no other bucket's deadline avoidably; ties (and traffic without
  deadlines) rotate round-robin across buckets, lanes rotate by
  :func:`~repro_torch.core.balance.round_robin_permutation` (§3.3.2), and
  requests within a bucket go earliest deadline first. The step cost is a
  fixed table or an EWMA of measured steps.
* **Cross-request telescoping** — every image of a batch shares the
  batched schedule, so one filter-chunk fetch per ``(n_block, chunk)``
  serves the batch (:meth:`VisionServer.schedule_counters`).

:class:`WallClock` serves real open-loop load (latency percentiles);
:class:`VirtualClock` with fixed step costs gives exact, replayable SLA
accounting. ``verify_artifacts`` (on by default) verifies the packed
chain at construction, and ``compiled`` (on by default) replays each
bucket's forward from a CUDA graph captured at its warm-up, as
:class:`~repro_torch.vision.engine.VisionEngine` does. ``mesh``
data-shards each bucket's slot batch over the ranks of a ``DeviceMesh``
(``num_slots / D`` lanes a rank, every output on every rank); the ranks
take each admission decision of the mesh's first rank, so a wall clock
that reads differently on each rank cannot split them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.balance import round_robin_permutation
from repro_torch.core.telescope import combine_schedule_requests
from repro_torch.kernels.worklist_core import schedule_counters
from repro_torch.vision import model as VM
from repro_torch.vision.engine import ImageRequest
from repro_torch.vision.mesh import agree, split_slots


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------
class VirtualClock:
    """Deterministic serving clock: time advances only when the server
    charges a step cost, so admission, latencies and SLA misses are exact
    functions of the request trace."""

    virtual = True

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    def sleep_until(self, t: float) -> None:
        self.t = max(self.t, t)

    def advance(self, dt: float) -> None:
        self.t += dt


class WallClock:
    """Real time, relative to construction."""

    virtual = False

    def __init__(self):
        self._epoch = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._epoch

    def sleep_until(self, t: float) -> None:
        d = t - self.now()
        if d > 0:
            time.sleep(d)

    def advance(self, dt: float) -> None:
        pass                      # real time advances on its own


# ---------------------------------------------------------------------------
# bookkeeping
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Pending:
    """One queued request after canonicalization."""
    rid: int
    image: np.ndarray             # canonical [bucket, bucket, C]
    bucket: int
    arrival_s: float
    deadline_s: Optional[float]


@dataclasses.dataclass
class RequestRecord:
    """Completion record for one served request."""
    rid: int
    bucket: int
    arrival_s: float
    deadline_s: Optional[float]
    done_s: float

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def missed(self) -> bool:
        return self.deadline_s is not None and self.done_s > self.deadline_s


@dataclasses.dataclass
class VisionServeStats:
    engine_steps: int = 0
    images: int = 0
    active_lane_steps: int = 0
    idle_lane_steps: int = 0
    deadlined: int = 0            # completed requests that carried an SLA
    sla_misses: int = 0
    wall_s: float = 0.0
    compile_s: float = 0.0
    bucket_steps: Dict[int, int] = dataclasses.field(default_factory=dict)
    latencies_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def slot_utilization(self) -> float:
        total = self.active_lane_steps + self.idle_lane_steps
        return self.active_lane_steps / total if total else 0.0

    @property
    def img_per_s(self) -> float:
        return self.images / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def sla_miss_rate(self) -> float:
        return self.sla_misses / max(self.deadlined, 1)

    def latency_percentiles(self) -> Dict[str, float]:
        if not self.latencies_s:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        lat = np.asarray(self.latencies_s)
        return {f"p{q}": float(np.percentile(lat, q)) for q in (50, 95, 99)}


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
class VisionServer:
    """Event-driven SLA-aware vision server on the model's device.

    ``buckets`` are the canonical input sizes, all run by one
    ``num_slots``-wide compiled forward. ``step_cost_s`` fixes the
    per-bucket step cost (a float for every bucket): required with a
    :class:`VirtualClock`, the EWMA estimator's seed under a
    :class:`WallClock` (which otherwise seeds from the warm-up).
    ``default_sla_s`` gives requests without a deadline ``arrival +
    sla`` (None: best effort).
    """

    def __init__(self, model: VM.VisionModel, *, num_slots: int = 4,
                 buckets: Sequence[int] = (24, 32),
                 default_sla_s: Optional[float] = None,
                 clock: Optional[object] = None,
                 step_cost_s: Union[None, float, Dict[int, float]] = None,
                 sub_m: int = 8, two_sided: bool = True,
                 schedule: str = "compact", im2col: str = "auto",
                 use_tuned: bool = False, verify_artifacts: bool = True,
                 compiled: bool = True, ewma: float = 0.3, mesh=None):
        if verify_artifacts:
            from repro_torch.analysis import raise_on_errors, verify_model
            raise_on_errors(
                verify_model(model, f"serve/{model.name}",
                             check_values=False),
                "VisionServer admission")
        if not buckets:
            raise ValueError("need at least one shape bucket")
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b)
                                                         for b in buckets)))
        self.default_sla_s = default_sla_s
        self.use_tuned = use_tuned
        self.clock = clock if clock is not None else WallClock()
        if isinstance(step_cost_s, dict):
            self._fixed_cost = {int(k): float(v)
                                for k, v in step_cost_s.items()}
        elif step_cost_s is not None:
            self._fixed_cost = {b: float(step_cost_s) for b in self.buckets}
        else:
            self._fixed_cost = None
        if getattr(self.clock, "virtual", False) and self._fixed_cost is None:
            raise ValueError("VirtualClock needs step_cost_s (deterministic "
                             "mode has no wall clock to measure)")
        if self._fixed_cost is not None:
            missing = [b for b in self.buckets if b not in self._fixed_cost]
            if missing:
                raise ValueError(f"step_cost_s missing buckets {missing}")
        self._ewma = ewma
        self.compiled = compiled
        # mesh: data-shard every bucket's slot batch; the work lists (and
        # the schedule counters' cache keys) are those of the local width
        self.mesh = mesh
        self.num_devices, self._local_slots = split_slots(num_slots, mesh)
        self._fwd = (VM.graphed_forward if compiled else VM.compile_forward)(
            model, sub_m=sub_m, two_sided=two_sided, schedule=schedule,
            im2col=im2col, use_tuned=use_tuned, mesh=mesh)
        self._channels = model.layers[0].conv.cin
        self._est: Dict[int, float] = dict(self._fixed_cost or {})
        self._warm: set = set()
        self._rr_bucket = 0
        self._rr_lane = 0
        self.queue: List[_Pending] = []
        self.produced: Dict[int, np.ndarray] = {}
        self.records: Dict[int, RequestRecord] = {}
        self.stats = VisionServeStats()

    # -- queue -------------------------------------------------------------
    def submit(self, req: ImageRequest) -> int:
        """Queue one request: route it to its shape bucket, canonicalize the
        image, apply the default SLA. Returns the bucket."""
        img = np.asarray(req.image, np.float32)
        if img.ndim != 3:
            raise ValueError(f"request {req.rid}: image must be [H, W, C]")
        bucket = VM.route_bucket(self.buckets, img.shape[0], img.shape[1])
        deadline = req.deadline_s
        if deadline is None and self.default_sla_s is not None:
            deadline = req.arrival_s + self.default_sla_s
        self.queue.append(_Pending(req.rid, VM.fit_image(img, bucket),
                                   bucket, float(req.arrival_s), deadline))
        return bucket

    @property
    def idle(self) -> bool:
        return not self.queue

    # -- admission ---------------------------------------------------------
    def _arrived(self, now: float) -> Dict[int, List[_Pending]]:
        by_bucket: Dict[int, List[_Pending]] = {}
        for p in self.queue:
            if p.arrival_s <= now:
                by_bucket.setdefault(p.bucket, []).append(p)
        for group in by_bucket.values():
            # EDF within a bucket (best effort last), arrival/rid tiebreak
            group.sort(key=lambda p: (p.deadline_s is None,
                                      p.deadline_s if p.deadline_s is not None
                                      else 0.0, p.arrival_s, p.rid))
        return by_bucket

    def _cost(self, bucket: int) -> float:
        est = self._est.get(bucket)
        return est if est is not None else max(self._est.values(), default=0.0)

    def _select_batch(self, now: float
                      ) -> Optional[Tuple[int, List[_Pending]]]:
        """Throughput-max over buckets subject to no avoidable deadline
        miss in the buckets left waiting; round-robin rotation breaks ties
        (and rules alone when nothing carries a deadline). When every
        choice busts something, the earliest-deadline bucket."""
        arrived = self._arrived(now)
        if not arrived:
            return None
        order = sorted(arrived)
        earliest: Dict[int, Optional[float]] = {
            b: next((p.deadline_s for p in arrived[b]
                     if p.deadline_s is not None), None)
            for b in order}

        def avoidable_miss(chosen: int) -> bool:
            # serving `chosen` first delays every other bucket by one step
            for b in order:
                if b == chosen or earliest[b] is None:
                    continue
                meets_now = now + self._cost(b) <= earliest[b]
                meets_after = (now + self._cost(chosen) + self._cost(b)
                               <= earliest[b])
                if meets_now and not meets_after:
                    return True
            return False

        feasible = [b for b in order if not avoidable_miss(b)]
        if not feasible:
            chosen = min((b for b in order if earliest[b] is not None),
                         key=lambda b: earliest[b])
        else:
            def throughput(b: int) -> float:
                cost = self._cost(b)
                ready = min(len(arrived[b]), self.num_slots)
                return ready / cost if cost > 0 else float(ready)
            best = max(throughput(b) for b in feasible)
            tied = [b for b in feasible if throughput(b) >= best - 1e-12]
            chosen = tied[self._rr_bucket % len(tied)]
            self._rr_bucket += 1
        return chosen, arrived[chosen][:self.num_slots]

    # -- engine ------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run (and, under a wall clock, measure) every bucket's batch up
        front, capturing its graph when compiled, charged to
        ``stats.compile_s``, never to latencies."""
        for bucket in self.buckets:
            self._warm_bucket(bucket)

    def _warm_bucket(self, bucket: int) -> None:
        if bucket in self._warm:
            return
        shape = (self.num_slots, bucket, bucket, self._channels)
        zeros = torch.zeros(shape, device=self.device)
        t0 = time.monotonic()
        self._fwd(zeros)
        self._sync()
        self.stats.compile_s += time.monotonic() - t0
        if bucket not in self._est:
            t1 = time.monotonic()
            self._fwd(zeros)
            self._sync()
            self._est[bucket] = max(time.monotonic() - t1, 1e-9)
        self._warm.add(bucket)

    def step(self) -> bool:
        """One event: admit the selected bucket batch and run it, or idle
        to the next arrival. Returns False when drained."""
        now = self.clock.now()
        sel = self._select_batch(now)
        if self.mesh is not None and self.mesh.size() > 1:
            # one decision for the mesh: its first rank's (the requests
            # and the queue are the same on every rank, the clocks not)
            plan = agree(None if sel is None else
                         (sel[0], [p.rid for p in sel[1]]), self.mesh)
            if plan is not None:
                by_rid = {p.rid: p for p in self.queue}
                sel = plan[0], [by_rid[r] for r in plan[1]]
            else:
                sel = None
        if sel is None:
            if not self.queue:
                return False
            self.clock.sleep_until(min(p.arrival_s for p in self.queue))
            return True
        bucket, batch_reqs = sel
        self._warm_bucket(bucket)
        batch = np.zeros((self.num_slots, bucket, bucket, self._channels),
                         np.float32)
        # §3.3.2 round-robin lanes (spread across lanes, don't pin lane 0)
        lanes = round_robin_permutation(self.num_slots,
                                        self._rr_lane)[:len(batch_reqs)]
        self._rr_lane += len(batch_reqs)
        for lane, p in zip(lanes, batch_reqs):
            batch[lane] = p.image
        t0 = time.monotonic()
        x = torch.from_numpy(batch)      # the graph copies it in itself
        out = self._fwd(x if self.compiled else x.to(self.device))
        out = out.cpu().numpy()
        measured = time.monotonic() - t0
        if self._fixed_cost is not None and getattr(
                self.clock, "virtual", False):
            self.clock.advance(self._fixed_cost[bucket])
        else:
            self._est[bucket] = ((1 - self._ewma)
                                 * self._est.get(bucket, measured)
                                 + self._ewma * measured)
        done = self.clock.now()
        admitted = {p.rid for p in batch_reqs}
        self.queue = [p for p in self.queue if p.rid not in admitted]
        self.stats.engine_steps += 1
        self.stats.active_lane_steps += len(batch_reqs)
        self.stats.idle_lane_steps += self.num_slots - len(batch_reqs)
        self.stats.bucket_steps[bucket] = \
            self.stats.bucket_steps.get(bucket, 0) + 1
        for lane, p in zip(lanes, batch_reqs):
            rec = RequestRecord(p.rid, bucket, p.arrival_s, p.deadline_s,
                                done)
            self.records[p.rid] = rec
            self.produced[p.rid] = out[lane]
            self.stats.images += 1
            self.stats.latencies_s.append(rec.latency_s)
            if p.deadline_s is not None:
                self.stats.deadlined += 1
                if rec.missed:
                    self.stats.sla_misses += 1
        return True

    def run(self, requests: Optional[List[ImageRequest]] = None
            ) -> Dict[int, np.ndarray]:
        """Serve ``requests`` (plus anything queued) to completion, after
        the warm-up of every bucket; under a wall clock the loop replays
        the arrival offsets in real time."""
        for r in requests or []:
            self.submit(r)
        self.warmup()
        t0 = time.monotonic()
        while self.step():
            pass
        self.stats.wall_s += time.monotonic() - t0
        return self.produced

    # -- telemetry ---------------------------------------------------------
    def schedule_counters(self) -> Optional[Dict[str, float]]:
        """Cross-request telescoped schedule counters, total and per
        bucket: each warmed bucket's layers cached one static work list per
        batch row-block count (``PackedConv.wl_cache``), which the static
        geometry walk (:func:`~repro_torch.vision.model.layer_geometry`)
        attributes to its bucket. ``None`` before any bucket warmed.

        Under a mesh the cache key is the per-device width ``num_slots /
        D``; ``per_bucket`` records are keyed ``"dev<d>/<bucket>"``, the
        totals sum over every (device, bucket) pair, and the record adds
        ``num_devices``."""
        sum_keys = ("scheduled_steps", "live_chunk_steps",
                    "flush_only_steps", "dense_grid_steps",
                    "filter_chunk_requests", "per_image_filter_fetches",
                    "combined_filter_fetches")
        per_bucket: Dict[str, Dict[str, float]] = {}
        requests = fetches = 0.0
        for bucket in sorted(self._warm):
            geo = VM.layer_geometry(self.model, bucket,
                                    use_tuned=self.use_tuned)
            records = []
            for layer, g in zip(self.model.layers, geo):
                wl = layer.conv.wl_cache.get(
                    self._local_slots * g["mb_per_img"])
                if wl is not None:
                    records.append(schedule_counters(
                        wl, combine=True, mb_per_img=g["mb_per_img"]))
                    c = combine_schedule_requests(
                        wl.k,
                        fetch_latency=wl.num_steps / max(wl.num_pairs, 1))
                    requests += c["requests"]
                    fetches += c["fetches"]
            if records:
                rec = {k: float(sum(r[k] for r in records))
                       for k in sum_keys}
                rec["cross_request_combine_factor"] = (
                    rec["per_image_filter_fetches"]
                    / max(rec["combined_filter_fetches"], 1.0))
                if self.num_devices > 1:
                    # each device walks the same local schedule over its
                    # own lanes: one record per (device, bucket)
                    for d in range(self.num_devices):
                        per_bucket[f"dev{d}/{bucket}"] = dict(rec)
                else:
                    per_bucket[str(bucket)] = rec
        if not per_bucket:
            return None
        requests *= self.num_devices
        fetches *= self.num_devices
        tot: Dict[str, float] = {
            k: float(sum(r[k] for r in per_bucket.values()))
            for k in sum_keys}
        tot["grid_compaction"] = 1.0 - (tot["scheduled_steps"]
                                        / max(tot["dense_grid_steps"], 1.0))
        tot["cross_request_combine_factor"] = (
            tot["per_image_filter_fetches"]
            / max(tot["combined_filter_fetches"], 1.0))
        # the intra-image §3.2 fetch-window combining model, for the
        # cross-request factor to be read against
        tot["schedule_requests"] = requests
        tot["schedule_fetches"] = fetches
        tot["combine_factor"] = requests / max(fetches, 1e-9)
        if self.num_devices > 1:
            tot["num_devices"] = self.num_devices
        tot["per_bucket"] = dict(per_bucket)
        return tot
