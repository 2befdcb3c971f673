"""MoE expert balancing (port of ``repro.sparsity.expert_balance``): the
paper's inter-filter balance at expert-parallel scale.

BARISTA's Greedy-Balance-Software sorts filters by density and deals them
serpentine across shards so each shard's total work matches. For MoE the
"density" is the observed expert load (routed token counts) and the
"shards" are the expert-parallel devices. :func:`rebalance` produces the
slot permutation the router reads (``params["expert_perm"]``); the deal
direction alternates with ``step`` (round robin), so a persistently hot
expert does not pin one device. The tracker and the permutations are host
numpy; :func:`expert_counts` takes the router's tensor of expert ids.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import balance


@dataclasses.dataclass
class ExpertLoadTracker:
    """EMA of per-expert token counts (host side, tiny)."""

    num_experts: int
    decay: float = 0.9
    load: Optional[np.ndarray] = None

    def update(self, counts) -> None:
        counts = np.asarray(counts, np.float64)
        if self.load is None:
            self.load = counts.copy()
        else:
            self.load = self.decay * self.load + (1 - self.decay) * counts

    def imbalance(self, num_shards: int) -> float:
        """Max/mean per-shard load under the identity placement."""
        if self.load is None:
            return 1.0
        return balance.balance_cost(self.load,
                                    np.arange(self.num_experts), num_shards)


def expert_counts(expert_ids: torch.Tensor, num_experts: int
                  ) -> torch.Tensor:
    """Histogram of routed expert ids ([T, K] -> int32 [E]) on their
    device."""
    return torch.bincount(expert_ids.reshape(-1).long(),
                          minlength=num_experts).to(torch.int32)


def rebalance(tracker: ExpertLoadTracker, num_shards: int,
              step: int = 0) -> np.ndarray:
    """New slot permutation: logical expert e -> slot ``perm_slots[e]``
    (int32). Slots are laid out shard-major (slot s on shard
    s % num_shards), so the serpentine deal of load-sorted experts
    balances each shard's work."""
    if tracker.load is None:
        return np.arange(tracker.num_experts, dtype=np.int32)
    order = balance.greedy_balance(tracker.load, num_shards, direction=step)
    return balance.invert_permutation(order).astype(np.int32)


def placement_imbalance(load, perm_slots, num_shards: int) -> float:
    """Max/mean per-shard load under a slot permutation (diagnostic)."""
    order = balance.invert_permutation(np.asarray(perm_slots, np.int64))
    return balance.balance_cost(np.asarray(load, np.float64), order,
                                num_shards)
