"""Benchmark layer tables of the paper's Table 1.

The part of ``repro.core.simulator`` the vision models read: the
:class:`LayerSpec` lists and each benchmark's filter / feature-map
densities. The cycle model itself is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    oh: int      # output height
    ow: int      # output width
    k: int       # filter spatial size
    d: int       # input channels
    n: int       # output channels (filters)

    def macs(self, batch: int = 32) -> float:
        return float(batch) * self.oh * self.ow * self.k * self.k * self.d * self.n


def _alexnet() -> List[LayerSpec]:
    return [LayerSpec(55, 55, 11, 3, 96), LayerSpec(27, 27, 5, 96, 256),
            LayerSpec(13, 13, 3, 256, 384), LayerSpec(13, 13, 3, 384, 384),
            LayerSpec(13, 13, 3, 384, 256)]


def _vgg16() -> List[LayerSpec]:
    cfg = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
           (56, 128, 256), (56, 256, 256), (56, 256, 256),
           (28, 256, 512), (28, 512, 512), (28, 512, 512),
           (14, 512, 512), (14, 512, 512), (14, 512, 512)]
    return [LayerSpec(s, s, 3, d, n) for s, d, n in cfg]


def _resnet18() -> List[LayerSpec]:
    layers = [LayerSpec(112, 112, 7, 3, 64)]
    for s, c, blocks in [(56, 64, 2), (28, 128, 2), (14, 256, 2), (7, 512, 2)]:
        for b in range(blocks):
            cin = c if not (b == 0 and c > 64) else c // 2
            layers.append(LayerSpec(s, s, 3, cin, c))
            layers.append(LayerSpec(s, s, 3, c, c))
    return layers  # 17 convs


def _resnet50() -> List[LayerSpec]:
    layers = [LayerSpec(112, 112, 7, 3, 64)]
    stages = [(56, 64, 256, 3), (28, 128, 512, 4), (14, 256, 1024, 6),
              (7, 512, 2048, 3)]
    cin = 64
    for s, mid, out, blocks in stages:
        for _ in range(blocks):
            layers.append(LayerSpec(s, s, 1, cin, mid))
            layers.append(LayerSpec(s, s, 3, mid, mid))
            layers.append(LayerSpec(s, s, 1, mid, out))
            cin = out
    return layers  # 49 convs


def _inception_v4() -> List[LayerSpec]:
    layers = [LayerSpec(149, 149, 3, 3, 32), LayerSpec(147, 147, 3, 32, 32),
              LayerSpec(147, 147, 3, 32, 64), LayerSpec(73, 73, 3, 64, 96),
              LayerSpec(71, 71, 3, 64, 96), LayerSpec(35, 35, 3, 192, 192),
              LayerSpec(35, 35, 1, 384, 96), LayerSpec(35, 35, 3, 96, 96),
              LayerSpec(17, 17, 1, 1024, 384), LayerSpec(17, 17, 7, 192, 224),
              LayerSpec(17, 17, 7, 224, 256), LayerSpec(8, 8, 3, 192, 192)]
    for _ in range(2):
        layers += [LayerSpec(8, 8, 1, 1536, 256), LayerSpec(8, 8, 1, 1536, 384),
                   LayerSpec(8, 8, 3, 384, 256), LayerSpec(8, 8, 3, 448, 512)]
    return layers  # 20 convs


@dataclasses.dataclass(frozen=True)
class Benchmark:
    name: str
    layers: Tuple[LayerSpec, ...]
    filter_density: float
    map_density: float


BENCHMARKS: Dict[str, Benchmark] = {
    "AlexNet": Benchmark("AlexNet", tuple(_alexnet()), 0.368, 0.473),
    "ResNet18": Benchmark("ResNet18", tuple(_resnet18()), 0.336, 0.486),
    "Inception-v4": Benchmark("Inception-v4", tuple(_inception_v4()), 0.570, 0.317),
    "VGGNet": Benchmark("VGGNet", tuple(_vgg16()), 0.334, 0.446),
    "ResNet50": Benchmark("ResNet50", tuple(_resnet50()), 0.421, 0.384),
}
