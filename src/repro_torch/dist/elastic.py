"""Elastic mesh planning, straggler detection, failure simulation (port of
``repro.dist.elastic``).

BARISTA's Section 3.4 balances work dynamically because static assignment
cannot predict which units run long. At datacenter scale the units are
hosts: re-plan the mesh when devices die (keep model parallelism, give up
data parallelism), flag hosts that are *persistently* slow, and rehearse
failures deterministically in tests. Plain host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A (pod, data, model) factorization of the surviving devices."""
    pod: int
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.pod * self.data * self.model

    def axis_shape(self) -> Dict[str, int]:
        out = {"data": self.data, "model": self.model}
        if self.pod > 1:
            out = {"pod": self.pod, **out}
        return out


def plan_mesh(alive_devices: int, *, model_parallel: int = 16,
              pod_size: int = 256) -> MeshPlan:
    """Largest usable mesh on ``alive_devices``: model parallelism never
    shrinks, failures cost data parallelism. Whole pods keep the pod axis;
    a ragged count collapses to one logical pod over whatever full
    model-parallel groups survive."""
    if alive_devices < model_parallel:
        raise ValueError(
            f"{alive_devices} devices cannot host model_parallel="
            f"{model_parallel}")
    if alive_devices % pod_size == 0 and pod_size % model_parallel == 0:
        pods = alive_devices // pod_size
        return MeshPlan(pods, pod_size // model_parallel, model_parallel)
    data = alive_devices // model_parallel
    return MeshPlan(1, data, model_parallel)


class StragglerDetector:
    """Flag hosts whose step time is persistently above the fleet median:
    slow in a round when above ``threshold`` x the median, flagged after
    ``patience`` consecutive slow rounds (one fast round clears the
    strikes)."""

    def __init__(self, num_hosts: int, patience: int = 3,
                 threshold: float = 1.5):
        self.num_hosts = num_hosts
        self.patience = patience
        self.threshold = threshold
        self._strikes = np.zeros(num_hosts, dtype=np.int64)

    def update(self, step_times: Sequence[float]) -> List[int]:
        """Record one round of per-host step times; return flagged hosts."""
        t = np.asarray(step_times, dtype=np.float64)
        if t.shape != (self.num_hosts,):
            raise ValueError(f"step_times shape {t.shape} != "
                             f"({self.num_hosts},)")
        slow = t > self.threshold * np.median(t)
        self._strikes = np.where(slow, self._strikes + 1, 0)
        return [int(i) for i in np.nonzero(
            self._strikes >= self.patience)[0]]


class FailureSimulator:
    """Deterministic device-failure schedule: ``fail_at`` maps step ->
    devices lost at that step (cumulative, permanent)."""

    def __init__(self, fail_at: Mapping[int, int]):
        self.fail_at = dict(fail_at)

    def surviving(self, step: int, total_devices: int) -> int:
        lost = sum(n for s, n in self.fail_at.items() if s <= step)
        return total_devices - lost
