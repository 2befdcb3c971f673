"""Conv geometry helpers, magnitude pruning and the activation tile
density (port of ``repro.core.sparse``).

``padtype_to_pads`` is a self-contained copy of the rule JAX's
``lax.padtype_to_pads`` applies for ``"SAME"``: the output keeps
``ceil(in / stride)`` pixels and the odd padding pixel goes at the *end*
(a 7x7 stride-2 stem on 224 px pads (2, 3)).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bitmask import chunk_occupancy

Stride = Union[int, Tuple[int, int]]
Padding = Union[str, Sequence[Tuple[int, int]]]


def normalize_stride(stride: Stride) -> Tuple[int, int]:
    """Accept an int (both axes) or an explicit ``(sh, sw)`` pair."""
    if isinstance(stride, int):
        return (stride, stride)
    sh, sw = stride
    return (int(sh), int(sw))


def normalize_padding(padding: Padding) -> Union[str, Tuple[Tuple[int, int], ...]]:
    """Accept ``"SAME"``/``"VALID"`` or explicit ``((ph0, ph1), (pw0, pw1))``."""
    if isinstance(padding, str):
        return padding.upper()
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def padtype_to_pads(in_shape: Sequence[int], window: Sequence[int],
                    strides: Sequence[int], padding: str
                    ) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) pads per spatial axis for ``"SAME"`` or ``"VALID"``."""
    padding = padding.upper()
    if padding == "VALID":
        return tuple((0, 0) for _ in in_shape)
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    pads = []
    for size, k, s in zip(in_shape, window, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def resolve_pads(hw: Tuple[int, int], kh: int, kw: int, stride: Stride,
                 padding: Padding) -> Tuple[Tuple[int, int], ...]:
    """Explicit (lo, hi) pads of a conv layer for an ``hw`` input."""
    pad = normalize_padding(padding)
    if isinstance(pad, str):
        return padtype_to_pads(hw, (kh, kw), normalize_stride(stride), pad)
    return pad


def activation_tile_density(x: torch.Tensor, block: int = 128,
                            valid_rows: Optional[int] = None,
                            valid_cols: Optional[int] = None
                            ) -> torch.Tensor:
    """Fraction of non-zero (row-block x k-chunk) activation tiles of ``x``
    (flattened to [-1, last dim]), a 0-d float32 tensor on ``x``'s device.

    The mean runs over the tiles that hold real data only: a caller
    measuring an operand already padded to the block grid passes its real
    extent as ``valid_rows`` / ``valid_cols``, and the all-zero padding
    tiles past it are not counted.
    """
    x2 = x.reshape(-1, x.shape[-1])
    m, k = x2.shape
    vr = m if valid_rows is None else min(valid_rows, m)
    vc = k if valid_cols is None else min(valid_cols, k)
    pm, pk = (-m) % block, (-k) % block
    occ = chunk_occupancy(F.pad(x2, (0, pk, 0, pm)), block, block)
    rt, ct = -(-vr // block), -(-vc // block)  # tiles overlapping real data
    return occ[:rt, :ct].float().mean()


def prune_by_magnitude(w: np.ndarray, density: float,
                       axis_out: int = -1) -> np.ndarray:
    """Per-filter magnitude pruning mask at a target density (each output
    channel keeps its own top-k magnitudes)."""
    w = np.asarray(w)
    wm = np.moveaxis(w, axis_out, -1)
    flat = np.abs(wm.reshape(-1, wm.shape[-1]))
    k = max(int(round(flat.shape[0] * density)), 1)
    thresh = np.partition(flat, -k, axis=0)[-k]
    mask = (flat >= thresh[None, :]).astype(w.dtype)
    mask = mask.reshape(wm.shape)
    return np.moveaxis(mask, -1, axis_out)
