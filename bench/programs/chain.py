"""A plain chain of convolutions: each layer's conv, ReLU and max-pool feed
the next."""
from __future__ import annotations

from typing import Dict, List

import torch


def build(config: Dict, filters: List[torch.Tensor], device):
    """The port's network from the benchmark's dense filters."""
    from repro_torch.sparsity.conv import build_sparse_chain
    from repro_torch.vision.model import VisionLayer, VisionModel
    pack = config["pack"]
    chain = build_sparse_chain(
        [f.cpu().numpy() for f in filters], density=float(config["density"]),
        num_shards=int(pack["num_shards"]),
        balance_filters=bool(pack["balance_filters"]),
        pattern=config["pattern"], micro_ranges=int(pack["micro_ranges"]),
        device=device)
    layers = [VisionLayer(conv, (l["stride"], l["stride"]), l["padding"],
                          tuple(l["pool_after"]) if l.get("pool_after")
                          else None)
              for l, conv in zip(config["layers"], chain)]
    return VisionModel(config["arch"], layers, int(config["input_size"]),
                       float(config["density"]), device)
