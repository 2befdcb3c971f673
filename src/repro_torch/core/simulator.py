"""Cycle-approximate analytical model of the paper's evaluated systems
(port of ``repro.core.simulator``, numpy host arithmetic).

The benchmarks of Table 1 (:class:`LayerSpec` lists with each network's
filter / feature-map densities), which the vision models also build, and
the 32K-MAC cycle model of Section 4 over Dense / One-sided / SCNN /
SparTen / SparTen-Iso / Synchronous / BARISTA-no-opts / BARISTA /
Unlimited-buffer / Ideal:

    cycles = compute(nonzero + zero + other) * imbalance + bandwidth_excess

* compute: effective MACs over the active MACs; which zeros each scheme
  elides is Section 5.2's breakdown;
* imbalance (the barrier loss): E[max]/mean of per-entity work over the G
  entities a broadcast synchronizes, 1 + cv_eff * sqrt(2 ln G), with
  cv_eff the work CV after averaging over the chunks between barriers;
* bandwidth_excess: refetch traffic beyond what overlaps with compute.

The constants (:data:`CALIB`) are the reference's, calibrated so the
geomean ratios land on the paper's headline numbers; every function keeps
the reference's order of arithmetic, so each :class:`SchemeResult` equals
the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import telescope


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

# paper Figure 7 orders benchmarks by increasing sparsity (opportunity)
FIG7_ORDER = ["Inception-v4", "ResNet50", "AlexNet", "ResNet18", "VGGNet"]

# ---------------------------------------------------------------------------
# Hardware parameters (paper Table 2) and calibrated model constants
# ---------------------------------------------------------------------------
MACS = 32768                 # 32K MACs in every configuration
CHUNK_BYTES = 128            # paper chunk
SPARSE_BANKS = 32
DENSE_BANKS = 8
BANK_BYTES_PER_CYCLE = 64    # cache bank width

CALIB = dict(
    cv_map=0.42,             # per-entity work CV from feature-map sparsity
    cv_filter_gb=0.12,       # filter work CV after greedy balancing
    chunks_per_barrier_sync=2.0,    # double buffering -> barrier each chunk set
    chunks_per_barrier_scnn=1.0,
    scnn_overhead=1.75,      # Cartesian-product overheads (intra/inter-PE idle)
    onesided_refetch=20.0,   # async cluster refetches of shared filters
    sparten_refetch=12.0,    # 1K async clusters refetching shared inputs
    noopts_refetch=58.0,     # paper: BARISTA w/o telescoping refetches 58x
    barista_refetch=2.0,     # paper: telescoping cuts 58 -> 7, ~3 effective
    burst_queue_async=2.2,   # bank-conflict queueing for bursty refetches
    burst_queue_barista=1.15,  # telescoping spreads/controls refetch bursts
    barista_color=1.008,     # residual loss each technique still leaves
    barista_rr=1.008,
    barista_residual=1.008,
    barista_chunks=64.0,     # deeper buffers -> longer effective intervals
    noopts_color=1.10,       # w/o coloring: input-map barrier inside nodes
    noopts_rr=1.08,          # w/o round-robin: systematic intra-filter skew
    noopts_hier=1.35,        # w/o hierarchical buffering: fewer chunks buffered
    sparten_iso_macs=0.60,   # iso-area SparTen keeps ~60% of the MACs
    sparten_local_barrier=32,  # SparTen: local broadcast inside 32-MAC cluster
)


def _expected_max_factor(cv: float, entities: int, chunks_avg: float = 1.0) -> float:
    """E[max]/mean for G entities whose work averages ``chunks_avg`` chunks."""
    if entities <= 1:
        return 1.0
    cv_eff = cv / math.sqrt(max(chunks_avg, 1.0))
    return 1.0 + cv_eff * math.sqrt(2.0 * math.log(entities))


# ---------------------------------------------------------------------------
# Per-scheme cycle model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SchemeResult:
    name: str
    cycles: float
    nonzero: float
    zero: float
    barrier: float
    bandwidth: float
    other: float

    def breakdown(self) -> Dict[str, float]:
        return {"nonzero": self.nonzero, "zero": self.zero,
                "barrier": self.barrier, "bandwidth": self.bandwidth,
                "other": self.other}


def _layer_traffic_bytes(layer: LayerSpec, fd: float, md: float,
                         batch: int = 32) -> Tuple[float, float]:
    in_bytes = batch * layer.oh * layer.ow * layer.d * md      # int8 sparse
    w_bytes = layer.k * layer.k * layer.d * layer.n * fd
    return in_bytes, w_bytes


def _simulate_layer(scheme: str, layer: LayerSpec, bench: Benchmark,
                    c: Dict[str, float], batch: int = 32) -> SchemeResult:
    fd, md = bench.filter_density, bench.map_density
    pd = fd * md
    macs = layer.macs(batch)
    in_b, w_b = _layer_traffic_bytes(layer, fd, md, batch)
    sparse_bw = SPARSE_BANKS * BANK_BYTES_PER_CYCLE
    dense_bw = DENSE_BANKS * BANK_BYTES_PER_CYCLE

    nonzero = macs * pd / MACS
    name = scheme

    if scheme == "Dense":
        zero = macs * (1 - pd) / MACS
        bw = (batch * layer.oh * layer.ow * layer.d + layer.k ** 2 * layer.d * layer.n) / dense_bw
        excess = max(0.0, bw - (nonzero + zero))
        return SchemeResult(name, nonzero + zero + excess, nonzero, zero, 0.0, excess, 0.0)

    if scheme == "Ideal":
        return SchemeResult(name, nonzero, nonzero, 0.0, 0.0, 0.0, 0.0)

    if scheme == "One-sided":
        # elides feature-map zeros only; filter zeros still computed
        zero = macs * (md - pd) / MACS
        compute = nonzero + zero
        traffic = (in_b + w_b * c["onesided_refetch"]) * c["burst_queue_async"]
        excess = max(0.0, traffic / sparse_bw - compute)
        return SchemeResult(name, compute + excess, nonzero, zero, 0.0, excess, 0.0)

    if scheme == "SCNN":
        compute = nonzero
        other = compute * (c["scnn_overhead"] - 1.0)
        # synchronous broadcasts across all clusters -> global barrier
        factor = _expected_max_factor(c["cv_map"], MACS // 32,
                                      c["chunks_per_barrier_scnn"])
        barrier = (compute + other) * (factor - 1.0)
        bw = (in_b + w_b) / sparse_bw
        excess = max(0.0, bw - (compute + other + barrier))
        return SchemeResult(name, compute + other + barrier + excess,
                            nonzero, 0.0, barrier, excess, other)

    if scheme in ("SparTen", "SparTen-Iso"):
        scale = c["sparten_iso_macs"] if scheme == "SparTen-Iso" else 1.0
        compute = nonzero / scale
        # local broadcast barrier inside each 32-MAC cluster only
        factor = _expected_max_factor(c["cv_map"], c["sparten_local_barrier"], 4.0)
        barrier = compute * (factor - 1.0)
        traffic = (in_b * c["sparten_refetch"] + w_b * 2.0) * c["burst_queue_async"]
        excess = max(0.0, traffic / sparse_bw - (compute + barrier))
        return SchemeResult(name, compute + barrier + excess,
                            nonzero / scale, 0.0, barrier, excess, 0.0)

    if scheme == "Synchronous":
        compute = nonzero
        # broadcast over an 8K-MAC cluster: 2K nodes synchronized
        factor = _expected_max_factor(c["cv_map"], 2048,
                                      c["chunks_per_barrier_sync"])
        barrier = compute * (factor - 1.0)
        bw = (in_b + w_b) / sparse_bw
        excess = max(0.0, bw - (compute + barrier))
        return SchemeResult(name, compute + barrier + excess,
                            nonzero, 0.0, barrier, excess, 0.0)

    if scheme == "BARISTA-no-opts":
        compute = nonzero
        imb = (c["noopts_color"] * c["noopts_rr"] *
               _expected_max_factor(c["cv_filter_gb"], 32, 16.0))
        barrier = compute * (imb - 1.0)
        traffic = (in_b * c["noopts_refetch"] * c["noopts_hier"] + w_b * 2.0) \
            * c["burst_queue_async"]
        excess = max(0.0, traffic / sparse_bw - (compute + barrier))
        return SchemeResult(name, compute + barrier + excess,
                            nonzero, 0.0, barrier, excess, 0.0)

    if scheme == "BARISTA":
        compute = nonzero
        imb = (c["barista_color"] * c["barista_rr"] * c["barista_residual"] *
               _expected_max_factor(c["cv_filter_gb"], 32, c["barista_chunks"]))
        barrier = compute * (imb - 1.0)
        traffic = (in_b * c["barista_refetch"] + w_b * 2.0) * c["burst_queue_barista"]
        excess = max(0.0, traffic / sparse_bw - (compute + barrier))
        return SchemeResult(name, compute + barrier + excess,
                            nonzero, 0.0, barrier, excess, 0.0)

    if scheme == "Unlimited-buffer":
        # broadcast with unlimited buffering: no barrier, no refetch
        compute = nonzero
        bw = (in_b + w_b) / sparse_bw
        excess = max(0.0, bw - compute)
        return SchemeResult(name, compute + excess, nonzero, 0.0, 0.0, excess, 0.0)

    raise ValueError(f"unknown scheme {scheme}")


SCHEMES = ["Dense", "One-sided", "SCNN", "SparTen", "SparTen-Iso",
           "Synchronous", "BARISTA-no-opts", "BARISTA", "Unlimited-buffer",
           "Ideal"]


def simulate(bench: Benchmark, scheme: str,
             overrides: Dict[str, float] | None = None) -> SchemeResult:
    """One scheme over every layer of ``bench``, summed field by field."""
    c = dict(CALIB)
    if overrides:
        c.update(overrides)
    acc = SchemeResult(scheme, 0, 0, 0, 0, 0, 0)
    for layer in bench.layers:
        r = _simulate_layer(scheme, layer, bench, c)
        acc.cycles += r.cycles
        acc.nonzero += r.nonzero
        acc.zero += r.zero
        acc.barrier += r.barrier
        acc.bandwidth += r.bandwidth
        acc.other += r.other
    return acc


def speedup_table() -> Dict[str, Dict[str, float]]:
    """Paper Fig. 7: per-benchmark speedup over Dense, plus geomean."""
    out: Dict[str, Dict[str, float]] = {}
    for name in FIG7_ORDER:
        bench = BENCHMARKS[name]
        dense = simulate(bench, "Dense").cycles
        out[name] = {s: dense / simulate(bench, s).cycles for s in SCHEMES}
    gm = {s: math.exp(np.mean([math.log(out[b][s]) for b in FIG7_ORDER]))
          for s in SCHEMES}
    out["geomean"] = gm
    return out


def isolation_table() -> Dict[str, Dict[str, float]]:
    """Paper Fig. 10: BARISTA's techniques enabled one after another, from
    no-opts: telescoping (refetches 58 -> 7), coloring (no input-map
    barrier inside nodes), hierarchical buffering (refetches 7 -> ~2,
    bursts controlled), round-robin (full BARISTA)."""
    steps = [
        ("SparTen", "SparTen", {}),
        ("BARISTA-no-opts", "BARISTA-no-opts", {}),
        ("+telescoping", "BARISTA-no-opts",
         {"noopts_refetch": 7.0, "noopts_hier": 1.0}),
        ("+coloring", "BARISTA-no-opts",
         {"noopts_refetch": 7.0, "noopts_hier": 1.0,
          "noopts_color": CALIB["barista_color"]}),
        ("+hierarchical", "BARISTA-no-opts",
         {"noopts_refetch": CALIB["barista_refetch"], "noopts_hier": 1.0,
          "burst_queue_async": CALIB["burst_queue_barista"],
          "noopts_color": CALIB["barista_color"]}),
        ("+round-robin (BARISTA)", "BARISTA", {}),
    ]
    out: Dict[str, Dict[str, float]] = {}
    for name in FIG7_ORDER:
        bench = BENCHMARKS[name]
        dense = simulate(bench, "Dense").cycles
        out[name] = {lbl: dense / simulate(bench, sch, ov).cycles
                     for lbl, sch, ov in steps}
    out["geomean"] = {lbl: math.exp(np.mean([math.log(out[b][lbl])
                                             for b in FIG7_ORDER]))
                      for lbl, _, _ in steps}
    return out


def buffer_sensitivity(buffer_mb: Sequence[float] = (4, 6, 8)) -> Dict[str, Dict[str, float]]:
    """Paper Fig. 11: average refetches against buffer size, with and
    without the optimizations (without hierarchical buffering and
    combining, nearly all 64 requests miss the in-flight window: the
    paper's 58 refetches)."""
    rng = np.random.default_rng(0)
    out: Dict[str, Dict[str, float]] = {}
    for name in FIG7_ORDER:
        spread = 4000.0 * BENCHMARKS[name].map_density  # denser -> more straying
        row = {"no-opts": telescope.uncombined_fetches(64, spread * 30, 40.0, rng)}
        depths = [max(int(b), 1) for b in buffer_mb]
        curve = telescope.refetch_curve(64, depths, spread, 40.0)
        for b_mb, f in zip(buffer_mb, curve):
            row[f"opts@{b_mb}MB"] = f
        out[name] = row
    return out
