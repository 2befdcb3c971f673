"""The yardstick: the work that a forward needs, counted from the inputs and
the shapes alone, and the card's published peaks.

Two-sided MACs are the products whose filter value and input activation are
both non-zero (the configuration's reference module counts them per image
and convolution, in ``forward(..., masks_out=...)``, from its own
activations and pruned filters). Bytes are every map read or written once
in fp32 (the reference's ``map_bytes``), and the non-zero filter values
once per forward. Neither count reads the program: no counter, tile size,
layout or im2col of it moves the yardstick, so a later kernel cannot read
above 100% of a bound made from them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

FP32_BYTES = 4

# Published dense peaks of one card (NVIDIA's H100 SXM data sheet, without
# sparsity, at the full 700 W limit): fp32 outside the tensor cores, and HBM.
# They hold only while the configurations run fp32 without tensor cores.
PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> Dict[str, float]:
    """The peaks of the card named ``device_name`` (as the driver names
    it); raises for a card the table does not hold."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    raise KeyError(f"no published peaks for {device_name!r}")


def filter_bytes(pruned: Sequence[np.ndarray]) -> int:
    """Bytes of the non-zero filter values, read once per forward."""
    return int(sum(int(np.count_nonzero(w)) for w in pruned)) * FP32_BYTES


def forward_bound_s(macs: int, images: int, map_bytes: int,
                    weight_bytes: int, peaks: Dict[str, float]) -> float:
    """The least time one forward of ``images`` images with ``macs``
    two-sided MACs in all can take: the larger of its operations over the
    fp32 peak and its bytes (``map_bytes`` of each image, by the
    configuration's reference, and the filters) over the memory
    bandwidth."""
    flops = 2.0 * macs
    nbytes = images * map_bytes + weight_bytes
    return max(flops / peaks["float32_flops"],
               nbytes / peaks["hbm_bytes_per_s"])
