"""A conv net with shortcuts (ResNet-50 v1.5): each layer reads the map its
``src`` names and adds the one its ``add`` names before its ReLU
(``bench/reference/residual.py`` describes the configuration's layers)."""
from __future__ import annotations

from typing import Dict, List

import torch


def build(config: Dict, filters: List[torch.Tensor], device):
    """The port's network from the benchmark's dense filters."""
    from repro_torch.vision.model import build_residual_model
    pack = config["pack"]
    return build_residual_model(
        config["arch"], [f.cpu().numpy() for f in filters], config["layers"],
        input_size=int(config["input_size"]),
        density=float(config["density"]),
        num_shards=int(pack["num_shards"]),
        balance_filters=bool(pack["balance_filters"]),
        pattern=config["pattern"], micro_ranges=int(pack["micro_ranges"]),
        device=device)
