"""Activation-sparsity instrumentation (port of
``repro.sparsity.instrument``).

The paper's feature-map sparsity comes from ReLU; the transformer analogue
is ReLU / squared-ReLU FFN activations (Nemotron, RWKV's channel-mix,
SeamlessM4T). These measure (a) the per-scalar activation density and (b)
the chunk-granular (128-wide tile) density the kernels can skip; the gap
between them is the cost of skipping at tile granularity.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core import bitmask as bm


def scalar_density(x: torch.Tensor) -> torch.Tensor:
    """Fraction of non-zero scalars (the paper's feature-map density)."""
    return torch.mean((x != 0).float())


def tile_density(x: torch.Tensor, block_m: int = 128,
                 block_k: int = 128) -> torch.Tensor:
    """Fraction of non-zero (row block x k-chunk) tiles, what the kernels
    skip; never below the scalar density."""
    x2 = x.reshape(-1, x.shape[-1])
    m, k = x2.shape
    x2 = F.pad(x2, (0, (-k) % block_k, 0, (-m) % block_m))
    return torch.mean(bm.chunk_occupancy(x2, block_m, block_k).float())


def lane_density(x: torch.Tensor, block_k: int = 128) -> torch.Tensor:
    """Per-row chunk density (row-granular skipping): the fraction of
    (row, k-chunk) pairs with any non-zero."""
    x2 = x.reshape(-1, x.shape[-1])
    m, k = x2.shape
    t = F.pad(x2, (0, (-k) % block_k)).reshape(m, -1, block_k)
    return torch.mean((t != 0).any(-1).float())


def ffn_sparsity_probe(h: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The three densities of a post-activation FFN hidden tensor."""
    return {"scalar": scalar_density(h),
            "tile_128": tile_density(h),
            "row_chunk": lane_density(h)}


def effective_flop_fraction(h: torch.Tensor, w_chunk_density: float,
                            block_m: int = 128, block_k: int = 128
                            ) -> torch.Tensor:
    """Two-sided compute fraction at chunk granularity: a tile is computed
    iff its weight chunk and its activation tile are both non-zero, so with
    independent placement the expected fraction is the product."""
    return tile_density(h, block_m, block_k) * w_chunk_density
