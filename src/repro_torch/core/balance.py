"""Load-balancing schemes from the paper (numpy copy of ``repro.core.balance``).

* :func:`greedy_balance` — GB-S: density-sorted boustrophedon assignment of
  output channels to shards, direction alternating per layer.
* :func:`fold_permutation` — repair scrambled output channels by permuting
  the next layer's input axis (offline, amortized over all inferences).
* :func:`round_robin_permutation` — rotated lane scan order (§3.3.2), used
  for serving slot admission.
* :func:`rotate_assignment` — static against round-robin lane imbalance
  over a run of inputs (the simulator's intra-filter model).
* :func:`expert_placement` — experts to devices, the MoE analogue of
  inter-filter balancing, rotated by step.
* :func:`balance_cost` — max/mean per-shard density of a placement (the
  MoE expert balancer's measure, ``sparsity.expert_balance``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def filter_density(w: np.ndarray, axis_out: int = -1) -> np.ndarray:
    """Per-output-channel non-zero density of a weight tensor."""
    w = np.moveaxis(np.asarray(w), axis_out, -1)
    flat = w.reshape(-1, w.shape[-1])
    return (flat != 0).mean(axis=0)


def greedy_balance(density: np.ndarray, num_shards: int,
                   direction: int = 0) -> np.ndarray:
    """GB-S variant: ``perm`` such that output channel ``perm[i]`` is
    processed in slot ``i``; consecutive slots deal serpentine over shards
    so every shard gets a near-identical density profile."""
    order = np.argsort(density, kind="stable")
    if direction % 2 == 1:
        order = order[::-1]
    n = order.shape[0]
    rows = -(-n // num_shards)
    perm = np.full(rows * num_shards, -1, np.int64)
    for r in range(rows):
        lo, hi = r * num_shards, min((r + 1) * num_shards, n)
        seg = order[lo:hi]
        if r % 2 == 1:
            seg = seg[::-1]
        perm[lo : lo + seg.shape[0]] = seg
    return perm[perm >= 0]


def balance_cost(density: np.ndarray, perm: np.ndarray,
                 num_shards: int) -> float:
    """Max/mean per-shard density of slots ``perm`` dealt shard by shard
    (slot ``i`` on shard ``i % num_shards``): 1.0 is perfect balance."""
    d = density[perm]
    d = np.concatenate([d, np.zeros((-d.shape[0]) % num_shards)])
    per_shard = d.reshape(-1, num_shards).sum(axis=0)
    return float(per_shard.max() / max(per_shard.mean(), 1e-12))


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return inv


def fold_permutation(next_w: np.ndarray, perm: np.ndarray,
                     axis_in: int = 0) -> np.ndarray:
    """The next layer reads its input-channel axis in ``perm`` order."""
    return np.take(np.asarray(next_w), perm, axis=axis_in)


def round_robin_assignment(num_subchunks: int, lanes: int,
                           step: int) -> np.ndarray:
    """Sub-chunk ``i`` goes to lane ``(i + step) % lanes`` (§3.3.2)."""
    if num_subchunks % lanes:
        raise ValueError(f"{num_subchunks} sub-chunks over {lanes} lanes")
    return (np.arange(num_subchunks) + step) % lanes


def round_robin_permutation(num_subchunks: int, step: int) -> np.ndarray:
    """Rotated scan order over ``num_subchunks`` lanes (one per lane)."""
    return round_robin_assignment(num_subchunks, num_subchunks, step)


def rotate_assignment(work: np.ndarray, lanes: int,
                      steps: int) -> Tuple[float, float]:
    """(static, round-robin) lane imbalance, max-lane / mean-lane
    aggregate work, of ``work`` [steps, num_subchunks] (per-input-chunk
    densities): static keeps the step-0 :func:`round_robin_assignment`,
    round-robin rotates it every input. ``steps`` is read from ``work``,
    as the reference does."""
    work = np.asarray(work, np.float64)
    steps_n, ns = work.shape
    per_lane_static = np.zeros(lanes)
    per_lane_rr = np.zeros(lanes)
    static = round_robin_assignment(ns, lanes, 0)
    for t in range(steps_n):
        np.add.at(per_lane_static, static, work[t])
        np.add.at(per_lane_rr, round_robin_assignment(ns, lanes, t), work[t])
    mean = work.sum() / lanes
    return (float(per_lane_static.max() / max(mean, 1e-12)),
            float(per_lane_rr.max() / max(mean, 1e-12)))


def expert_placement(expert_load: np.ndarray, num_devices: int,
                     step: int = 0) -> np.ndarray:
    """``device_of_expert`` [num_experts]: experts sorted by load and dealt
    serpentine over devices (:func:`greedy_balance`, direction by
    ``step``), the deal rotated by ``step`` so a persistently hot expert
    does not pin one device for the whole run."""
    num_experts = expert_load.shape[0]
    perm = greedy_balance(np.asarray(expert_load, np.float64), num_devices,
                          direction=step)
    device_of_expert = np.empty(num_experts, np.int64)
    for slot, e in enumerate(perm):
        device_of_expert[e] = (slot + step) % num_devices
    return device_of_expert
