"""Plain reference of a conv net with shortcuts (ResNet-50 v1.5), in
PyTorch and numpy: the reference module of a configuration whose
``"topology"`` is ``"residual"``.

Each entry of the configuration's ``layers`` is one convolution in
execution order: ``k``, ``cin``, ``cout``, ``stride``, explicit
``padding`` ``[[top, bottom], [left, right]]``, and its wiring: ``src``,
the layer whose output it reads (-1: the image), ``add``, the layer whose
output is added to the convolution's before the ReLU (null: none),
``relu``, and ``pool_after``, ``[window, stride, padding]`` of a max-pool
(null: none). A layer's output is its map after that pool.

It prunes the dense filters that the benchmark made from the seed with
the chain reference's frozen rules (:mod:`bench.reference.chain`), then
runs every layer as ``F.conv2d`` on the explicitly padded map, the
shortcut's add, the ReLU where the layer has one and the max-pool, with
channels in their original order throughout. It imports nothing of the
program under test.

``precision="float32"`` is the configuration's arithmetic (TF32 off);
``precision="tf32"`` the correctness check's control, as the chain's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench.reference.chain import device_filters, prune_filters, to_tf32
from bench.reference.counts import FP32_BYTES

__all__ = ["prune_filters", "device_filters", "forward", "map_bytes",
           "output_sides", "bottleneck_layers"]


def bottleneck_layers(widths: Sequence[int] = (64, 128, 256, 512),
                      blocks: Sequence[int] = (3, 4, 6, 3), *,
                      stem: int = 64, channels: int = 3,
                      expansion: int = 4) -> List[Dict]:
    """The ``layers`` of a ResNet v1.5 of bottleneck blocks (arXiv:1512.03385,
    Table 1; the defaults are its 50-layer column): the 7x7 stride-2 stem
    and its 3x3 stride-2 max-pool padded by 1, then per stage ``blocks``
    blocks of a 1x1, a 3x3 (the stage's stride on its first block, from the
    second stage on) and a 1x1 of ``expansion`` times the width, whose
    output adds the block's input, or on a block that changes width or
    side its projection: a 1x1 at the block's stride without ReLU, placed
    before the conv that adds it."""
    layers: List[Dict] = []

    def conv(k, cin, cout, stride, src, add=None, relu=True, pool=None):
        p = (k - 1) // 2
        layers.append({"k": k, "cin": cin, "cout": cout, "stride": stride,
                       "padding": [[p, p], [p, p]], "src": src, "add": add,
                       "relu": relu, "pool_after": pool})
        return len(layers) - 1

    x = conv(7, channels, stem, 2, -1, pool=[3, 2, 1])
    cin = stem
    for stage, (width, n) in enumerate(zip(widths, blocks)):
        out = expansion * width
        for b in range(n):
            s = 2 if stage > 0 and b == 0 else 1
            c1 = conv(1, cin, width, 1, x)
            c2 = conv(3, width, width, s, c1)
            shortcut = x
            if s != 1 or cin != out:
                shortcut = conv(1, cin, out, s, x, relu=False)
            x = conv(1, width, out, 1, c2, add=shortcut)
            cin = out
    return layers


def output_sides(config: Dict, size: int) -> List[Dict[str, int]]:
    """Per layer, for a square ``size`` input: the side of the map it
    reads (``h``), of its convolution's output (``oh``) and of its output
    after the pool (``out``)."""
    sides: List[Dict[str, int]] = []
    for layer in config["layers"]:
        h = size if layer["src"] == -1 else sides[layer["src"]]["out"]
        (top, bottom), _ = layer["padding"]
        oh = (h + top + bottom - layer["k"]) // layer["stride"] + 1
        out = oh
        pool = layer.get("pool_after")
        if pool and oh + 2 * pool[2] >= pool[0]:
            out = (oh + 2 * pool[2] - pool[0]) // pool[1] + 1
        sides.append({"h": h, "oh": oh, "out": out})
    return sides


def map_bytes(config: Dict, size: int) -> int:
    """Bytes of one square ``size`` image's maps in fp32: every
    convolution's input map and output map once each, and, for each
    layer with a shortcut, the shortcut's map once more (the add reads it
    beside the convolution's own output). A map that several layers read
    counts once per reader."""
    total = 0
    for layer, s in zip(config["layers"], output_sides(config, size)):
        total += s["h"] ** 2 * layer["cin"] + s["oh"] ** 2 * layer["cout"]
        if layer["add"] is not None:
            total += s["oh"] ** 2 * layer["cout"]
    return total * FP32_BYTES


def _last_reads(layers: Sequence[Dict]) -> Dict[int, int]:
    """Each map's last reader (a map no later layer reads is dropped)."""
    last: Dict[int, int] = {}
    for i, layer in enumerate(layers):
        last[layer["src"]] = i
        if layer["add"] is not None:
            last[layer["add"]] = i
    return last


@torch.no_grad()
def forward(config: Dict, filters: Sequence[torch.Tensor], x: torch.Tensor,
            precision: str = "float32",
            masks_out: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Final maps [B, h, w, C] of NHWC images ``x`` through the net.

    ``masks_out``, when given, receives each convolution's two-sided MAC
    count per image (int64 [B]): the products whose input activation and
    filter value are both non-zero, from a convolution of the 0/1 masks in
    float64; count with ``precision="float32"``."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision == "tf32"
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        layers = config["layers"]
        last = _last_reads(layers)
        end = len(layers) - 1
        maps = {-1: x.permute(0, 3, 1, 2)}
        for i, (layer, w) in enumerate(zip(layers, filters)):
            (top, bottom), (left, right) = layer["padding"]
            y = F.pad(maps[layer["src"]], (left, right, top, bottom))
            s = layer["stride"]
            if masks_out is not None:
                # filter non-zeros summed over the output channels, in
                # float64: exact whatever algorithm the library picks
                wn = (w != 0).double().sum(dim=0, keepdim=True)
                cnt = F.conv2d((y != 0).double(), wn, stride=s)
                masks_out.append(
                    cnt.round().to(torch.int64).flatten(1).sum(1))
            if tf32:
                y, w = to_tf32(y), to_tf32(w)
            y = F.conv2d(y, w, stride=s)
            if layer["add"] is not None:
                y = y + maps[layer["add"]]
            if layer["relu"]:
                y = torch.clamp_min(y, 0.0)
            pool = layer.get("pool_after")
            if pool and min(y.shape[2], y.shape[3]) + 2 * pool[2] >= pool[0]:
                y = F.max_pool2d(y, pool[0], pool[1], pool[2])
            maps[i] = y
            for j in [j for j in maps if j != end and last.get(j, -2) <= i]:
                del maps[j]
        return maps[end].permute(0, 2, 3, 1).contiguous()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
