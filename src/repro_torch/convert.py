"""Carry a packed network across from the JAX reference.

:func:`model_from_reference` takes, per layer, the reference model's numpy
arrays and settings and returns the port's :class:`VisionModel` on a given
device, so both packages can run the very same packed weights. The caller
extracts the arrays (``np.asarray`` of the reference's device arrays); this
module imports nothing of the reference.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bitmask import BlockSparseMatrix
from repro_torch.core.simulator import BENCHMARKS
from repro_torch.sparsity.conv import PackedConv
from repro_torch.vision.model import ARCH_STEM, VisionLayer, VisionModel

LAYER_KEYS = ("w_dense", "perm", "indices", "vals", "bk", "bn", "layout",
              "stride", "padding", "pool_after")


def _padding(p):
    return p if isinstance(p, str) else tuple(tuple(int(v) for v in lo_hi)
                                              for lo_hi in p)


def model_from_reference(layers: Sequence[Mapping], *,
                         name: str = "VGGNet",
                         input_size: Optional[int] = None,
                         density: Optional[float] = None,
                         device="cuda") -> VisionModel:
    """Build the port's model from per-layer reference arrays.

    Each entry holds ``w_dense`` [kh, kw, cin, cout] (pruned, chain-folded),
    ``perm``, the packed ``indices`` [nb, max_nz] and ``vals`` [nb, max_nz,
    bk, bn], ``bk``, ``bn``, ``layout``, ``stride``, ``padding`` and
    ``pool_after``, and optionally ``pattern``. ``input_size`` and
    ``density`` default to the benchmark's canonical size and Table-1
    filter density.
    """
    input_size = ARCH_STEM[name][0] if input_size is None else input_size
    density = BENCHMARKS[name].filter_density if density is None \
        else density
    device = torch.device(device)
    out = []
    for i, lay in enumerate(layers):
        missing = [k for k in LAYER_KEYS if k not in lay]
        if missing:
            raise KeyError(f"layer {i} lacks {missing}")
        w = np.array(lay["w_dense"], np.float32)
        indices = np.array(lay["indices"], np.int32)
        vals = np.array(lay["vals"], np.float32)
        bk, bn = int(lay["bk"]), int(lay["bn"])
        kh, kw, cin, cout = w.shape
        K = -(-kh * kw * cin // bk) * bk
        nb = indices.shape[0]
        if vals.shape != (nb, indices.shape[1], bk, bn) or nb * bn < cout:
            raise ValueError(f"layer {i}: vals {vals.shape} / indices "
                             f"{indices.shape} do not pack a {w.shape} "
                             f"filter at ({bk}, {bn})")
        packed = BlockSparseMatrix(
            torch.as_tensor(indices, device=device),
            torch.as_tensor(vals, device=device), (K, nb * bn), bk, bn,
            indices_np=indices)
        conv = PackedConv(w, packed, np.asarray(lay["perm"]),
                          layout=lay["layout"],
                          pattern=lay.get("pattern", "unstructured"))
        pool = lay["pool_after"]
        out.append(VisionLayer(
            conv, tuple(int(s) for s in lay["stride"]),
            _padding(lay["padding"]),
            None if pool is None else (int(pool[0]), int(pool[1]))))
    return VisionModel(name, out, input_size, density, device)
