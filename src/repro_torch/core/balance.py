"""Load-balancing schemes from the paper (numpy copy of ``repro.core.balance``).

* :func:`greedy_balance` — GB-S: density-sorted boustrophedon assignment of
  output channels to shards, direction alternating per layer.
* :func:`fold_permutation` — repair scrambled output channels by permuting
  the next layer's input axis (offline, amortized over all inferences).
* :func:`round_robin_permutation` — rotated lane scan order (§3.3.2), used
  for serving slot admission.
* :func:`balance_cost` — max/mean per-shard density of a placement (the
  MoE expert balancer's measure, ``sparsity.expert_balance``).
"""
from __future__ import annotations

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
