"""Chunked bit-mask sparse tensor representation (BARISTA / SparTen format).

Port of ``repro.core.bitmask``. Two layouts:

* :class:`BitmaskVector` — per-scalar mask + packed values, the paper's
  representation (used by the reference sparse ops).
* :class:`BlockSparseMatrix` — chunk-granular block sparsity: a [K, N]
  matrix cut into ``bk``-row chunks and ``bn``-column blocks; for each
  column block the list of K-chunk ids holding any non-zero, padded with -1
  to the longest list. This is what both conv kernels consume.

Packing happens on the host in numpy (bit-equal to the reference) and the
packed arrays then live as tensors on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

CHUNK = 128  # paper chunk size


# ---------------------------------------------------------------------------
# Per-scalar bitmask vectors (paper-faithful representation)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BitmaskVector:
    """1-D sparse vector in bit-mask format.

    mask:   bool  [num_chunks, CHUNK]   — non-zero positions
    values: float [num_chunks, cap]     — packed non-zeros, zero-padded
    length: original (unpadded) length
    """

    mask: torch.Tensor
    values: torch.Tensor
    length: int

    @property
    def num_chunks(self) -> int:
        return self.mask.shape[0]

    @property
    def capacity(self) -> int:
        return self.values.shape[1]

    def nnz(self) -> torch.Tensor:
        return self.mask.sum()


def encode(x: np.ndarray, capacity: int | None = None, *,
           device="cuda") -> BitmaskVector:
    """Encode a 1-D array into bit-mask format (host side)."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError(f"encode takes a 1-D array, got shape {x.shape}")
    n = x.shape[0]
    padded = int(np.ceil(n / CHUNK)) * CHUNK
    xp = np.zeros(padded, x.dtype)
    xp[:n] = x
    xp = xp.reshape(-1, CHUNK)
    mask = xp != 0
    cap = capacity if capacity is not None else max(int(mask.sum(1).max(initial=0)), 1)
    vals = np.zeros((xp.shape[0], cap), x.dtype)
    for c in range(xp.shape[0]):
        nz = xp[c][mask[c]][:cap]
        vals[c, : nz.shape[0]] = nz
    return BitmaskVector(torch.as_tensor(mask, device=device),
                         torch.as_tensor(vals, device=device), n)


def _slots(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    # prefix sum of the mask: which packed slot holds each position
    return (torch.cumsum(mask.to(torch.int64), dim=1) - 1).clamp(0, capacity - 1)


def decode(v: BitmaskVector) -> torch.Tensor:
    """Inverse of :func:`encode`."""
    gathered = torch.gather(v.values, 1, _slots(v.mask, v.capacity))
    dense = torch.where(v.mask, gathered, torch.zeros_like(gathered))
    return dense.reshape(-1)[: v.length]


def match_and_multiply(a: BitmaskVector, b: BitmaskVector) -> torch.Tensor:
    """Sparse dot product via mask AND + prefix-sum matching (the PE)."""
    if a.num_chunks != b.num_chunks:
        raise ValueError(f"chunk counts differ: {a.num_chunks} vs {b.num_chunks}")
    both = a.mask & b.mask
    va = torch.gather(a.values, 1, _slots(a.mask, a.capacity)).float()
    vb = torch.gather(b.values, 1, _slots(b.mask, b.capacity)).float()
    return torch.where(both, va * vb, torch.zeros_like(va)).sum()


def match_count(a: BitmaskVector, b: BitmaskVector) -> torch.Tensor:
    """Number of effective MACs for the pair (simulator work metric)."""
    return (a.mask & b.mask).sum()


# ---------------------------------------------------------------------------
# Chunk-granular block sparsity (kernel layout)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BlockSparseMatrix:
    """[K, N] matrix, K cut into ``bk`` chunks, N into ``bn`` blocks.

    indices: int32 [n_blocks, max_nz]          — K-chunk ids, -1 padded
    vals:    float32 [n_blocks, max_nz, bk, bn] — the non-zero chunk tiles
    shape:   (K, N)
    indices_np: host copy of ``indices`` kept from pack time, so schedules
        are built without reading back from the device.
    wl_cache: static (weight-only) work lists keyed by row-block count.
    shard_of: optional int32 [n_blocks] cluster assignment.
    """

    indices: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]
    bk: int
    bn: int
    indices_np: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)
    wl_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    shard_of: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def host_indices(self) -> np.ndarray:
        """Chunk index lists as host numpy (pack-time copy when available)."""
        if self.indices_np is None:
            self.indices_np = self.indices.cpu().numpy()
        return self.indices_np

    @property
    def n_blocks(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nz(self) -> int:
        return self.indices.shape[1]

    def density(self) -> float:
        nz = int((self.host_indices() >= 0).sum())
        total = (self.shape[0] // self.bk) * self.n_blocks
        return nz / max(total, 1)


def block_sparsify(w: np.ndarray, bk: int = CHUNK, bn: int = CHUNK,
                   pad_to: int | None = None, *,
                   device="cuda") -> BlockSparseMatrix:
    """Host packing of a dense [K, N] matrix into block-sparse layout on
    ``device``. A (k-chunk, n-block) tile is kept iff it holds any
    non-zero; every column block's list is padded to the longest one."""
    w = np.asarray(w)
    K, N = w.shape
    if K % bk or N % bn:
        raise ValueError(f"[{K}, {N}] does not tile by ({bk}, {bn})")
    kb, nb = K // bk, N // bn
    tiles = w.reshape(kb, bk, nb, bn).transpose(2, 0, 1, 3)  # [nb, kb, bk, bn]
    occupied = (tiles != 0).any(axis=(2, 3))  # [nb, kb]
    max_nz = int(occupied.sum(1).max(initial=0))
    if pad_to is not None:
        max_nz = max(max_nz, pad_to)
    max_nz = max(max_nz, 1)
    indices = np.full((nb, max_nz), -1, np.int32)
    vals = np.zeros((nb, max_nz, bk, bn), w.dtype)
    for n in range(nb):
        ks = np.nonzero(occupied[n])[0]
        indices[n, : ks.shape[0]] = ks
        vals[n, : ks.shape[0]] = tiles[n, ks]
    return BlockSparseMatrix(torch.as_tensor(indices, device=device),
                             torch.as_tensor(vals, device=device), (K, N),
                             bk, bn, indices_np=indices)


def block_densify(m: BlockSparseMatrix) -> torch.Tensor:
    """Reconstruction of the dense [K, N] matrix (oracle support)."""
    K, N = m.shape
    kb, nb = K // m.bk, N // m.bn
    out = torch.zeros((nb, kb, m.bk, m.bn), dtype=m.vals.dtype,
                      device=m.vals.device)
    valid = m.indices >= 0
    safe = torch.where(valid, m.indices, 0).long()
    contrib = torch.where(valid[..., None, None], m.vals,
                          torch.zeros_like(m.vals))
    rows = torch.arange(nb, device=m.vals.device)[:, None].expand_as(safe)
    out.index_put_((rows, safe), contrib, accumulate=True)
    return out.permute(1, 2, 0, 3).reshape(K, N)


def chunk_occupancy(x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """[M, K] activations -> bool [M//bm, K//bk] tile-occupancy map."""
    M, K = x.shape
    t = x.reshape(M // bm, bm, K // bk, bk)
    return (t != 0).any(dim=3).any(dim=1)
