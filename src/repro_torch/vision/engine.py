"""Batched vision inference engine: round-robin slot admission over the
sparse CNN forward (port of ``repro.vision.engine``).

A request is one image; a step runs the whole network on the current slot
batch and every live slot retires. Free slots are scanned in an order
rotated by :func:`repro_torch.core.balance.round_robin_permutation`
(§3.3.2), and the batch is always ``num_slots`` wide: free lanes carry zero
images, whose row blocks the two-sided skip elides.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.balance import round_robin_permutation
from repro_torch.core.telescope import combine_schedule_requests
from repro_torch.kernels.worklist_core import schedule_counters
from repro_torch.obs import span
from repro_torch.vision import model as VM
from repro_torch.vision.mesh import data_counters, split_slots


@dataclasses.dataclass
class ImageRequest:
    """One inference request. ``arrival`` is the engine step from which
    :class:`VisionEngine` may admit it (deterministic admission, no clock);
    ``arrival_s`` / ``deadline_s`` are seconds from the start of a run,
    read by :class:`repro_torch.serve.vision.VisionServer` (``deadline_s``
    None: best effort, never an SLA miss)."""
    rid: int
    image: np.ndarray            # [H, W, C] float32
    arrival: int = 0
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class VisionStats:
    engine_steps: int = 0
    images: int = 0
    active_lane_steps: int = 0
    idle_lane_steps: int = 0
    wall_s: float = 0.0
    compile_s: float = 0.0        # first-call set-up, kept out of wall_s

    @property
    def slot_utilization(self) -> float:
        total = self.active_lane_steps + self.idle_lane_steps
        return self.active_lane_steps / total if total else 0.0

    @property
    def img_per_s(self) -> float:
        return self.images / self.wall_s if self.wall_s > 0 else 0.0


class VisionEngine:
    """Image queue + slot table driving the sparse CNN forward on the
    model's device. ``num_slots`` is the fixed batch width; outputs are
    the network's final feature maps (host numpy), keyed by request id.
    ``verify_artifacts`` (on by default) verifies the packed chain at
    construction, before anything launches; ``compiled`` (on by default, as
    the reference jits its forward) replays the forward captured per batch
    shape (:func:`~repro_torch.vision.model.graphed_forward`; the warm-up
    captures it, each step copies the host batch into the graph's input),
    ``compiled=False`` runs the eager forward.

    ``mesh`` (a ``DeviceMesh`` with a ``data`` dim; every rank runs the
    same engine on the same requests) data-shards the slot batch:
    ``num_slots`` divides over the data extent ``D``, each rank runs the
    forward on its ``num_slots / D`` lanes and every rank receives every
    lane's output (:func:`repro_torch.vision.mesh.shard_forward`), bitwise
    the unsharded engine's. Admission is a function of the engine's step
    clock, so the ranks admit alike without talking."""

    def __init__(self, model: VM.VisionModel, *, num_slots: int = 4,
                 sub_m: int = 8, two_sided: bool = True,
                 schedule: str = "compact", im2col: str = "auto",
                 use_tuned: bool = False, verify_artifacts: bool = True,
                 compiled: bool = True, mesh=None):
        # admission gate: an engine admits arbitrary checkpoints, so the
        # packed chain (and its cached schedules' device copies, which the
        # walker reads as raw offsets) is verified before any launch;
        # verify_artifacts=False opts hot construction paths out.
        if verify_artifacts:
            from repro_torch.analysis import raise_on_errors, verify_model
            raise_on_errors(
                verify_model(model, f"engine/{model.name}",
                             check_values=False),
                "VisionEngine admission")
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.sub_m = sub_m
        self.two_sided = two_sided
        self.compiled = compiled
        self.mesh = mesh
        self.num_devices, self._local_slots = split_slots(num_slots, mesh)
        self._fwd = (VM.graphed_forward if compiled else VM.compile_forward)(
            model, sub_m=sub_m, two_sided=two_sided, schedule=schedule,
            im2col=im2col, use_tuned=use_tuned, mesh=mesh)
        self._warm_shapes: set = set()
        self.slot_req = np.full(num_slots, -1, np.int64)
        self._slot_img: List[Optional[np.ndarray]] = [None] * num_slots
        self._image_shape: Optional[tuple] = None
        self._rr = 0
        self.clock = 0
        self.queue: Deque[ImageRequest] = deque()
        self.produced: Dict[int, np.ndarray] = {}
        self.done_at: Dict[int, int] = {}
        self.stats = VisionStats()

    def schedule_counters(self) -> Optional[Dict[str, float]]:
        """Network totals of the static work lists this engine's batch
        geometry runs (the record of
        :func:`repro_torch.kernels.worklist_core.schedule_counters` summed
        over layers), with ``grid_compaction``, the §3.2 combining model
        totals and the exact cross-request dedup counters. ``None`` before
        the first step (no work lists built yet). Under a mesh the work
        lists are those of the per-device width ``num_slots / D``, and the
        record adds ``num_devices``, ``per_device_steps``,
        ``step_imbalance`` and ``step_scaling_efficiency`` (every rank walks
        the same local schedule: an exact balance)."""
        wls = [wl for layer in self.model.layers
               for wl in layer.conv.wl_cache.values()]
        # count only this engine's per-device batch geometry: other engines
        # sharing the model leave their own widths in the cache
        mine = [wl for wl in wls
                if wl.mb_per_img
                and wl.mb == self._local_slots * wl.mb_per_img]
        wls = mine or wls
        if not wls:
            return None
        records = [schedule_counters(wl, combine=True) for wl in wls]
        sum_keys = ("scheduled_steps", "live_chunk_steps",
                    "flush_only_steps", "dense_grid_steps",
                    "filter_chunk_requests", "per_image_filter_fetches",
                    "combined_filter_fetches")
        tot: Dict[str, float] = {k: float(sum(r[k] for r in records))
                                 for k in sum_keys}
        tot["grid_compaction"] = 1.0 - (tot["scheduled_steps"]
                                        / max(tot["dense_grid_steps"], 1.0))
        tot["cross_request_combine_factor"] = (
            tot["per_image_filter_fetches"]
            / max(tot["combined_filter_fetches"], 1.0))
        combining = [combine_schedule_requests(
            wl.k, fetch_latency=wl.num_steps / max(wl.num_pairs, 1))
            for wl in wls]
        tot["schedule_requests"] = float(
            sum(c["requests"] for c in combining))
        tot["schedule_fetches"] = float(
            sum(c["fetches"] for c in combining))
        tot["combine_factor"] = (tot["schedule_requests"]
                                 / max(tot["schedule_fetches"], 1e-9))
        if self.mesh is not None:
            tot.update(data_counters(wls, self.num_devices))
        return tot

    # -- queue -------------------------------------------------------------
    def submit(self, req: ImageRequest) -> None:
        img = np.asarray(req.image, np.float32)
        if img.ndim != 3:
            raise ValueError(f"request {req.rid}: image must be [H, W, C]")
        if self._image_shape is None:
            self._image_shape = img.shape
        elif img.shape != self._image_shape:
            raise ValueError(
                f"request {req.rid}: image shape {img.shape} != engine "
                f"shape {self._image_shape} (one engine serves one size)")
        self.queue.append(ImageRequest(req.rid, img, req.arrival))

    @property
    def idle(self) -> bool:
        return not self.queue and not (self.slot_req >= 0).any()

    # -- slot lifecycle ----------------------------------------------------
    def _next_arrived(self) -> Optional[ImageRequest]:
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
            self.slot_req[s] = req.rid
            self._slot_img[s] = req.image
            self._rr += 1

    # -- engine ------------------------------------------------------------
    def step(self) -> bool:
        """One engine tick: admissions, then one whole-network forward over
        the slot batch; all live slots retire. Returns False when idle.
        Under a recording profiler the tick is an ``engine.step`` span
        holding ``engine.admit``, ``engine.assemble``, ``engine.forward``,
        ``engine.copy_out`` (the wait for the forward and the copy back)
        and ``engine.retire`` (:mod:`repro_torch.obs`)."""
        with span("engine.step"):
            with span("engine.admit"):
                self._admit_ready()
            active = self.slot_req >= 0
            if not active.any():
                if self.queue:               # waiting on future arrivals
                    self.clock += 1
                    return True
                return False
            with span("engine.assemble"):
                batch = np.zeros((self.num_slots,) + self._image_shape,
                                 np.float32)
                for s in np.nonzero(active)[0]:
                    batch[s] = self._slot_img[s]
                x = torch.from_numpy(batch)  # the graph copies it in itself
            self._warmup(batch.shape)
            with span("engine.forward"):
                out = self._fwd(x if self.compiled else x.to(self.device))
            with span("engine.copy_out"):
                out = out.cpu().numpy()
            with span("engine.retire"):
                self.stats.engine_steps += 1
                self.stats.active_lane_steps += int(active.sum())
                self.stats.idle_lane_steps += int((~active).sum())
                for s in np.nonzero(active)[0]:
                    rid = int(self.slot_req[s])
                    self.produced[rid] = out[s]
                    self.done_at[rid] = self.clock
                    self.stats.images += 1
                    self.slot_req[s] = -1
                    self._slot_img[s] = None
                self.clock += 1
            return True

    def _warmup(self, batch_shape) -> None:
        """Run the forward once per batch shape — building its work lists,
        copying their schedules to the device, on first use building the
        kernels and, when compiled, capturing the graph — charged to
        ``stats.compile_s``."""
        if batch_shape in self._warm_shapes:
            return
        with span("engine.warmup"):
            t0 = time.perf_counter()
            self._fwd(torch.zeros(batch_shape, device=self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats.compile_s += time.perf_counter() - t0
        self._warm_shapes.add(batch_shape)

    def run(self, requests: Optional[List[ImageRequest]] = None
            ) -> Dict[int, np.ndarray]:
        """Serve ``requests`` (plus anything queued) to completion; returns
        {rid: final feature map} and fills ``self.stats``."""
        for r in requests or []:
            self.submit(r)
        if self._image_shape is not None:
            self._warmup((self.num_slots,) + self._image_shape)
        t0 = time.perf_counter()
        while self.step():
            pass
        self.stats.wall_s += time.perf_counter() - t0
        return self.produced
