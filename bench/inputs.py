"""The inputs of a run, made from ``--seed`` on the device: the dense
He-normal filters of a configuration and the pool of images the requests
show. Both sides of the comparison get the same tensors."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def make_inputs(config: Dict, pool: int, side: int, seed: int,
                device) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(dense filters [k, k, cin, cout] each, fp32, He-normal, on
    ``device``; ``pool`` images [pool, side, side, cin] of |N(0, 1)|),
    drawn by one generator on the device in two calls."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    shapes = [(l["k"], l["k"], l["cin"], l["cout"]) for l in config["layers"]]
    sizes = [k * k * cin * cout for k, _, cin, cout in shapes]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    filters = []
    for (k, _, cin, cout), part in zip(shapes, flat.split(sizes)):
        he = (2.0 / (k * k * cin)) ** 0.5
        filters.append(part.view(k, k, cin, cout) * he)
    cin0 = config["layers"][0]["cin"]
    images = torch.randn(pool, side, side, cin0, generator=g,
                         device=device).abs_()
    return filters, images
