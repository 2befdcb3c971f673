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
from repro_torch.vision import model as VM


@dataclasses.dataclass
class ImageRequest:
    """One inference request; ``arrival`` is the engine step from which it
    may be admitted (deterministic admission, no clock involved)."""
    rid: int
    image: np.ndarray            # [H, W, C] float32
    arrival: int = 0


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
    ``verify_artifacts`` and ``mesh`` are not ported yet."""

    def __init__(self, model: VM.VisionModel, *, num_slots: int = 4,
                 sub_m: int = 8, two_sided: bool = True,
                 schedule: str = "compact", im2col: str = "auto",
                 use_tuned: bool = False, verify_artifacts: bool = False,
                 mesh=None):
        if verify_artifacts:
            raise NotImplementedError(
                "the artifact verifier is not ported yet")
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.sub_m = sub_m
        self.two_sided = two_sided
        self._fwd = VM.compile_forward(
            model, sub_m=sub_m, two_sided=two_sided, schedule=schedule,
            im2col=im2col, use_tuned=use_tuned)
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
        the first step (no work lists built yet)."""
        wls = [wl for layer in self.model.layers
               for wl in layer.conv.wl_cache.values()]
        # count only this engine's batch geometry: other engines sharing
        # the model leave their own widths in the cache
        mine = [wl for wl in wls
                if wl.mb_per_img and wl.mb == self.num_slots * wl.mb_per_img]
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
        the slot batch; all live slots retire. Returns False when idle."""
        self._admit_ready()
        active = self.slot_req >= 0
        if not active.any():
            if self.queue:               # waiting on future arrivals
                self.clock += 1
                return True
            return False
        batch = np.zeros((self.num_slots,) + self._image_shape, np.float32)
        for s in np.nonzero(active)[0]:
            batch[s] = self._slot_img[s]
        self._warmup(batch.shape)
        out = self._fwd(torch.as_tensor(batch, device=self.device))
        out = out.cpu().numpy()
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
        copying their schedules to the device and, on first use, building
        the kernels — charged to ``stats.compile_s``."""
        if batch_shape in self._warm_shapes:
            return
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
