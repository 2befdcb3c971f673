"""Plain reference of the benchmark's conv chains, in PyTorch and numpy:
the reference module of a configuration without a ``"topology"`` key.

It reads the topology from a configuration file of ``bench/configs`` and
works everything out again from the dense filters that the benchmark made
from the seed: the pruning (a frozen copy of the rule the configuration
names), then every layer as ``F.conv2d`` with its padding, a ReLU and the
max-pool after it. Channels stay in their original order throughout, so
the final maps compare directly with the program's (whose last layer is
left unpermuted). It imports nothing of the program under test.

``precision="float32"`` is the configuration's arithmetic (TF32 off).
``precision="tf32"`` is the control of the correctness check: the
operands of every convolution rounded to TF32's 10-bit mantissa, and on a
card TF32 allowed as well, the step a later change might be tempted by.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference.counts import FP32_BYTES

# the packing's chunk (the paper's 128) and the narrowest layer that the
# chunk pattern prunes by whole tiles; narrower stems prune per filter
CHUNK = 128
MIN_TAP_CIN = 16


def load_config(path) -> Dict:
    return json.loads(Path(path).read_text())


# ---------------------------------------------------------------------------
# pruning: a frozen copy of the rules the configurations name
# ---------------------------------------------------------------------------
def chunk_layout(shape: Tuple[int, int, int, int],
                 chunk: int = CHUNK) -> Tuple[str, int, int]:
    """(layout, bk, bn) of a [kh, kw, cin, cout] filter under the chunk
    pattern: tap-major tiles where the channels fill whole chunks, else
    (the stem) the channel-major layout, pruned per filter."""
    kh, kw, cin, cout = shape
    bn = chunk if cout % chunk == 0 else min(cout, chunk)
    if cin >= MIN_TAP_CIN and (cin % chunk == 0 or cin <= chunk):
        return "tap", (chunk if cin % chunk == 0 else cin), bn
    k = kh * kw * cin
    return "channel", min(-(-k // 8) * 8, chunk), bn


def prune_per_filter(w: np.ndarray, density: float) -> np.ndarray:
    """Each output filter keeps its ``round(density * fan_in)`` largest
    magnitudes (ties at the threshold kept)."""
    flat = np.abs(w.reshape(-1, w.shape[-1]))
    k = max(int(round(flat.shape[0] * density)), 1)
    thresh = np.partition(flat, -k, axis=0)[-k]
    return w * (flat >= thresh[None, :]).reshape(w.shape).astype(w.dtype)


def _bank_quotas(score: np.ndarray, total: int) -> np.ndarray:
    kb, nb = score.shape
    base, extra = divmod(total, nb)
    quota = np.full(nb, base, np.int64)
    if extra:
        quota[np.argsort(-score.sum(axis=0), kind="stable")[:extra]] += 1
    return np.minimum(quota, kb)


def _range_quotas(scores: np.ndarray, bounds: np.ndarray,
                  quota: int) -> np.ndarray:
    sizes = np.diff(bounds)
    exact = quota * sizes / sizes.sum()
    take = np.floor(exact).astype(np.int64)
    rem = quota - take.sum()
    if rem > 0:
        resid = np.array([
            np.sort(scores[bounds[g]:bounds[g + 1]])[::-1][take[g]]
            if take[g] < sizes[g] else -np.inf
            for g in range(sizes.shape[0])])
        order = sorted(range(len(sizes)),
                       key=lambda g: (-(exact - take)[g], -resid[g]))
        for g in order:
            if rem == 0:
                break
            if take[g] < sizes[g]:
                take[g] += 1
                rem -= 1
    while rem > 0:
        for g in np.argsort(-sizes, kind="stable"):
            if take[g] < sizes[g]:
                take[g] += 1
                rem -= 1
                break
    return take


def prune_tiles(w: np.ndarray, density: float, bk: int, bn: int,
                micro_ranges: int) -> np.ndarray:
    """Keep ``round(density * tiles)`` whole (bk x bn) tiles of the
    tap-major [kh*kw*cin, cout] matrix by their squared L2 energy, the
    quota split evenly over the column banks (the surplus to the most
    energetic banks) and, within a bank, over ``micro_ranges`` contiguous
    ranges of its k-chunks; kept tiles untouched, the rest zero."""
    kh, kw, cin, cout = w.shape
    K = kh * kw * cin
    wm = w.reshape(K, cout)
    pad_n = (-cout) % bn
    if pad_n:
        wm = np.pad(wm, ((0, 0), (0, pad_n)))
    kb, nb = K // bk, wm.shape[1] // bn
    tiles = wm.reshape(kb, bk, nb, bn)
    score = np.square(tiles).sum(axis=(1, 3))
    quota = _bank_quotas(score, int(round(min(max(density, 0.0), 1.0)
                                          * kb * nb)))
    g = max(1, min(micro_ranges, kb))
    bounds = np.linspace(0, kb, g + 1).astype(np.int64)
    keep = np.zeros((kb, nb), bool)
    for n in range(nb):
        take = _range_quotas(score[:, n], bounds, int(quota[n]))
        for r in range(g):
            lo, hi = int(bounds[r]), int(bounds[r + 1])
            if take[r]:
                local = np.argsort(-score[lo:hi, n], kind="stable")[:take[r]]
                keep[lo + local, n] = True
    pruned = np.where(keep[:, None, :, None], tiles, 0.0)
    return pruned.reshape(K, nb * bn)[:, :cout].reshape(w.shape).astype(
        np.float32)


def prune_filters(config: Dict, dense: Sequence[np.ndarray]
                  ) -> List[np.ndarray]:
    """The configuration's pruning of each dense [kh, kw, cin, cout]
    filter, in the original channel order."""
    density = float(config["density"])
    pattern = config["pattern"]
    micro = int(config["pack"]["micro_ranges"])
    out = []
    for w in dense:
        w = np.asarray(w, np.float32)
        layout, bk, bn = chunk_layout(w.shape)
        if density >= 1.0:
            out.append(w.copy())
        elif pattern == "chunk" and layout == "tap":
            out.append(prune_tiles(w, density, bk, bn, micro))
        elif pattern in ("chunk", "unstructured"):
            out.append(prune_per_filter(w, density))
        else:
            raise ValueError(f"unknown pattern {pattern!r}")
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """SAME padding: ``ceil(size / s)`` outputs, the odd pixel at the
    end."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def output_sides(config: Dict, size: int) -> List[Tuple[int, int]]:
    """(input side, output side before the pool) of every layer for a
    square ``size`` input."""
    sides = []
    h = size
    for layer in config["layers"]:
        k, s = layer["k"], layer["stride"]
        if layer["padding"] == "SAME":
            oh = -(-h // s)
        else:
            oh = (h - k) // s + 1
        sides.append((h, oh))
        h = oh
        pool = layer.get("pool_after")
        if pool and h >= pool[0]:
            h = (h - pool[0]) // pool[1] + 1
    return sides


def map_bytes(config: Dict, size: int) -> int:
    """Bytes of every layer's input and output map for one square
    ``size`` image, once each (a chain has no map that two layers read)."""
    total = 0
    for layer, (h, oh) in zip(config["layers"], output_sides(config, size)):
        total += h * h * layer["cin"] + oh * oh * layer["cout"]
    return total * FP32_BYTES


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits, to nearest, ties to even)."""
    b = t.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def device_filters(pruned: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """[kh, kw, cin, cout] numpy filters as OIHW tensors on ``device``."""
    return [torch.as_tensor(np.ascontiguousarray(w)).to(device)
            .permute(3, 2, 0, 1).contiguous() for w in pruned]


@torch.no_grad()
def forward(config: Dict, filters: Sequence[torch.Tensor], x: torch.Tensor,
            precision: str = "float32",
            masks_out: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Final maps [B, h, w, C] of NHWC images ``x`` through the chain.

    ``masks_out``, when given, receives each layer's two-sided MAC count
    per image (int64 [B]): the products whose input activation and filter
    value are both non-zero, from a convolution of the 0/1 masks; count with
    ``precision="float32"``."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision == "tf32"
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        y = x.permute(0, 3, 1, 2)
        for layer, w in zip(config["layers"], filters):
            k, s = layer["k"], layer["stride"]
            if layer["padding"] == "SAME":
                ph = same_pads(y.shape[2], k, s)
                pw = same_pads(y.shape[3], k, s)
            else:
                ph = pw = (0, 0)
            y = F.pad(y, (pw[0], pw[1], ph[0], ph[1]))
            if masks_out is not None:
                # filter non-zeros summed over the output channels: one
                # output channel counts every output channel's products;
                # in float64, exact whatever algorithm the library picks
                wn = (w != 0).double().sum(dim=0, keepdim=True)
                cnt = F.conv2d((y != 0).double(), wn, stride=s)
                masks_out.append(
                    cnt.round().to(torch.int64).flatten(1).sum(1))
            if tf32:
                y, w = to_tf32(y), to_tf32(w)
            y = torch.clamp_min(F.conv2d(y, w, stride=s), 0.0)
            pool = layer.get("pool_after")
            if pool and min(y.shape[2], y.shape[3]) >= pool[0]:
                y = F.max_pool2d(y, pool[0], pool[1])
        return y.permute(0, 2, 3, 1).contiguous()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def fit(image: np.ndarray, size: int) -> np.ndarray:
    """An [h, w, C] image zero-padded at the bottom and right to
    [size, size, C] (no side may exceed ``size``)."""
    h, w, _ = image.shape
    if h > size or w > size:
        raise ValueError(f"image {image.shape} exceeds the {size} bucket")
    return np.pad(image, ((0, size - h), (0, size - w), (0, 0)))
