"""Full-network sparse CNN forward for the Table-1 benchmarks (port of
``repro.vision.model``).

The paper's benchmark topologies (:mod:`repro_torch.core.simulator`) become
runnable networks: He-initialized filters drawn from a numpy RNG (so the
weights equal the reference's for the same seed), pruned to the paper's
densities, packed by the conv-aware chain (:mod:`repro_torch.sparsity.conv`)
and run layer by layer through the implicit-GEMM sparse conv with fused
ReLU (:mod:`repro_torch.kernels.sparse_conv`). Pooling placement is derived
statically from the spec list. Tensors are NHWC float32 on the model's
device throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import simulator as S
from repro_torch.core.sparse import Padding, Stride, normalize_stride, \
    resolve_pads
from repro_torch.kernels.sparse_conv import conv_out_size, sparse_conv2d_nhwc
from repro_torch.kernels.worklist_core import DEFAULT_BM
from repro_torch.sparsity.conv import PackedConv, build_sparse_chain

# stem geometry per arch: (canonical input size, layer-0 stride, padding)
ARCH_STEM: Dict[str, Tuple[int, Tuple[int, int], str]] = {
    "AlexNet": (227, (4, 4), "VALID"),
    "VGGNet": (224, (1, 1), "SAME"),
    "ResNet18": (224, (2, 2), "SAME"),
    "ResNet50": (224, (2, 2), "SAME"),
}
SUPPORTED_ARCHS = tuple(ARCH_STEM)


@dataclasses.dataclass
class VisionLayer:
    conv: PackedConv
    stride: Tuple[int, int]
    padding: Padding
    pool_after: Optional[Tuple[int, int]]  # (window, stride) max-pool or None


@dataclasses.dataclass
class VisionModel:
    name: str
    layers: List[VisionLayer]
    input_size: int
    density: float                # pruning target (paper Table 1 filters)
    device: torch.device
    _fwd_cache: Dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def num_layers(self) -> int:
        return len(self.layers)


def _pool_between(prev_oh: int, next_oh: int) -> Optional[Tuple[int, int]]:
    """Max-pool (window, stride) mapping the spec's spatial step, if any."""
    if next_oh >= prev_oh:
        return None
    for k, s in ((2, 2), (3, 2), (2, 3), (3, 3)):
        if (prev_oh - k) // s + 1 == next_oh:
            return (k, s)
    raise ValueError(f"no pool maps {prev_oh} -> {next_oh}")


def build_vision_model(name: str = "VGGNet", *,
                       density: Optional[float] = None, seed: int = 0,
                       num_layers: Optional[int] = None,
                       balance_filters: bool = True,
                       num_shards: int = 16,
                       pattern: str = "unstructured",
                       mesh_devices: Optional[int] = None,
                       device="cuda") -> VisionModel:
    """Synthetic pruned network for one benchmark, packed on ``device``.

    ``density`` defaults to the paper's Table-1 filter density;
    ``num_layers`` truncates the chain. ``pattern="chunk"`` prunes at tile
    granularity in the tap-major layout; ``mesh_devices`` runs the
    pack-time cluster balance so work lists carry a per-device shard map.
    """
    if name not in ARCH_STEM:
        raise ValueError(f"{name} does not linearize into a conv chain; "
                         f"supported: {SUPPORTED_ARCHS}")
    if num_layers is not None and num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    device = torch.device(device)
    bench = S.BENCHMARKS[name]
    specs = list(bench.layers)
    if num_layers is not None:
        specs = specs[:num_layers]
    for a, b in zip(specs, specs[1:]):
        if a.n != b.d:
            raise ValueError(f"{name} chain break: {a} -> {b}")
    density = bench.filter_density if density is None else density
    rng = np.random.default_rng(seed)
    weights = []
    for spec in specs:
        fan_in = spec.k * spec.k * spec.d
        weights.append((rng.normal(size=(spec.k, spec.k, spec.d, spec.n))
                        * np.sqrt(2.0 / fan_in)).astype(np.float32))
    chain = build_sparse_chain(weights, density=density,
                               num_shards=num_shards,
                               balance_filters=balance_filters,
                               pattern=pattern, mesh_devices=mesh_devices,
                               device=device)
    stem_size, stem_stride, stem_pad = ARCH_STEM[name]
    layers: List[VisionLayer] = []
    for i, (spec, conv) in enumerate(zip(specs, chain)):
        stride: Stride = stem_stride if i == 0 else (1, 1)
        padding: Padding = stem_pad if i == 0 else "SAME"
        pool = (_pool_between(spec.oh, specs[i + 1].oh)
                if i + 1 < len(specs) else None)
        layers.append(VisionLayer(conv, stride, padding, pool))
    return VisionModel(name, layers, stem_size, density, device)


def layer_geometry(model: VisionModel, input_size: int, *,
                   bm_rows: int = DEFAULT_BM,
                   use_tuned: bool = False) -> List[Dict[str, int]]:
    """Static per-layer geometry walk for one input size (host arithmetic
    only): ``oh/ow/m_img/m_pad/bm_rows/mb_per_img`` per layer, with the pool
    placement rule of :func:`max_pool`."""
    if use_tuned:
        raise NotImplementedError("autotuned tile configs are not ported yet")
    out: List[Dict[str, int]] = []
    h = w = input_size
    for layer in model.layers:
        c = layer.conv
        oh, ow = conv_out_size(h, w, c.kh, c.kw, layer.stride, layer.padding)
        m_img = oh * ow
        m_pad = m_img + (-m_img) % bm_rows
        out.append({"oh": oh, "ow": ow, "m_img": m_img, "m_pad": m_pad,
                    "bm_rows": bm_rows, "mb_per_img": m_pad // bm_rows})
        h, w = oh, ow
        if layer.pool_after is not None and min(h, w) >= layer.pool_after[0]:
            win, s = layer.pool_after
            h = (h - win) // s + 1
            w = (w - win) // s + 1
    return out


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Channel-wise VALID max-pool of NHWC ``x`` (skipped when the map is
    already smaller than the window)."""
    if min(x.shape[1], x.shape[2]) < window:
        return x
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _forward_layers(model: VisionModel, x: torch.Tensor, *, sub_m: int,
                    two_sided: bool, schedule: str,
                    im2col: str) -> torch.Tensor:
    """Every layer through the sparse conv, activations handed on-device."""
    for layer in model.layers:
        c = layer.conv
        x, _ = sparse_conv2d_nhwc(
            x, c.packed, c.kh, c.kw, c.cout, stride=layer.stride,
            padding=layer.padding, sub_m=sub_m, bm_rows=DEFAULT_BM,
            im2col=im2col, two_sided=two_sided, fuse_relu=True,
            schedule=schedule, layout=c.layout, wl_cache=c.wl_cache)
        if layer.pool_after is not None:
            x = max_pool(x, *layer.pool_after)
    return x


def compile_forward(model: VisionModel, *, sub_m: int = 8,
                    two_sided: bool = True, schedule: str = "compact",
                    im2col: str = "auto", use_tuned: bool = False,
                    mesh=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The whole-net forward as a closure cached on the model per config.

    Each layer's static work list is built once per row-block count (cached
    on ``PackedConv.wl_cache``) and its schedule arrays are copied to the
    device once (cached on the work list), so a call launches kernels and
    copies no schedule. ``use_tuned`` and ``mesh`` are not ported yet.
    """
    if use_tuned:
        raise NotImplementedError("autotuned tile configs are not ported yet")
    if mesh is not None:
        raise NotImplementedError("the mesh-sharded forward is not ported yet")
    key = (sub_m, two_sided, schedule, im2col)
    fn = model._fwd_cache.get(key)
    if fn is None:
        @torch.no_grad()
        def fn(x: torch.Tensor) -> torch.Tensor:
            return _forward_layers(model, x, sub_m=sub_m,
                                   two_sided=two_sided, schedule=schedule,
                                   im2col=im2col)
        model._fwd_cache[key] = fn
    return fn


@torch.no_grad()
def forward(model: VisionModel, x: torch.Tensor, *, sub_m: int = 8,
            two_sided: bool = True, collect_stats: bool = False,
            schedule: str = "compact", im2col: str = "auto",
            compiled: Optional[bool] = None, use_tuned: bool = False
            ) -> Tuple[torch.Tensor, List[Dict[str, float]]]:
    """Whole network through the sparse conv path. x: [B, H, W, 3] float32
    on the model's device.

    By default the cached work-list forward runs (:func:`compile_forward`).
    ``collect_stats`` runs the instrumented per-layer path instead — the
    dense-grid kernel with its ``count_macs`` counters — and returns one
    dict per layer with the measured densities, the executed vs skippable
    tile MACs and the compacted schedule's step counts.
    """
    if use_tuned:
        raise NotImplementedError("autotuned tile configs are not ported yet")
    if compiled is None:
        compiled = not collect_stats
    if compiled and not collect_stats:
        fn = compile_forward(model, sub_m=sub_m, two_sided=two_sided,
                             schedule=schedule, im2col=im2col)
        return fn(x), []
    stats: List[Dict[str, float]] = []
    bench = S.BENCHMARKS[model.name]
    for i, layer in enumerate(model.layers):
        c = layer.conv
        if collect_stats:
            map_scalar = float((x != 0).float().mean())
        out, aux = sparse_conv2d_nhwc(
            x, c.packed, c.kh, c.kw, c.cout, stride=layer.stride,
            padding=layer.padding, sub_m=sub_m, two_sided=two_sided,
            fuse_relu=True, emit_occupancy=collect_stats,
            count_macs=collect_stats,
            schedule="dense" if collect_stats else schedule,
            im2col=im2col, layout=c.layout, wl_cache=c.wl_cache,
            compact_activations=collect_stats,
            report_schedule=collect_stats)
        if collect_stats:
            counts = aux["mac_counts"]
            executed = float(counts.sum())
            n_chunks = int((c.packed.host_indices() >= 0).sum())
            # denominators at the kernel's own tiling, in the counters'
            # unit: sub-block MACs two-sided, whole tiles one-sided
            mb_total = int(counts.shape[1])
            units = mb_total * (DEFAULT_BM // sub_m) if two_sided \
                else mb_total
            kb = c.packed.shape[0] // c.packed.bk
            weight_tile = n_chunks * units
            dense_tile = c.packed.n_blocks * kb * units
            sched = aux["schedule"]
            stats.append({
                "scheduled_steps": sched["scheduled_steps"],
                "live_chunk_steps": sched["live_chunk_steps"],
                "flush_only_steps": sched["flush_only_steps"],
                "dense_grid_steps": sched["dense_grid_steps"],
                "static_scheduled_steps": sched["static_scheduled_steps"],
                "schedule_requests": sched["combining"]["requests"],
                "schedule_fetches": sched["combining"]["fetches"],
                "combine_factor": sched["combining"]["combine_factor"],
                "layer": i,
                "kh": c.kh, "cin": c.cin, "cout": c.cout,
                "macs": float(x.shape[0]) * aux["oh"] * aux["ow"]
                        * c.kh * c.kw * c.cin * c.cout,
                "map_scalar_density": map_scalar,
                "filter_scalar_density": c.scalar_density(),
                "filter_chunk_density": c.chunk_density(),
                "dead_chunk_fraction": c.dead_chunk_fraction(),
                "layout": c.layout,
                "pattern": c.pattern,
                "paper_map_density": bench.map_density,
                "paper_filter_density": bench.filter_density,
                "executed_tile_macs": executed,
                "weight_tile_macs": float(weight_tile),
                "dense_tile_macs": float(dense_tile),
                "skipped_tile_frac": 1.0 - executed / max(weight_tile, 1),
                "out_occupancy_density":
                    float(aux["occupancy"].float().mean()),
                "spec_oh": bench.layers[i].oh,
            })
        x = out
        if layer.pool_after is not None:
            x = max_pool(x, *layer.pool_after)
    return x, stats


@torch.no_grad()
def dense_forward(model: VisionModel, x: torch.Tensor) -> torch.Tensor:
    """Oracle: the same pruned (chain-folded) filters through ``F.conv2d``
    + ReLU + pooling, in full fp32 (TF32 off: cuDNN turns it on for
    convolutions by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    y = x.permute(0, 3, 1, 2)
    for layer in model.layers:
        c = layer.conv
        w = torch.as_tensor(c.w_dense, device=x.device).permute(3, 2, 0, 1)
        (ph0, ph1), (pw0, pw1) = resolve_pads(tuple(y.shape[2:]), c.kh,
                                              c.kw, layer.stride,
                                              layer.padding)
        y = F.conv2d(F.pad(y, (pw0, pw1, ph0, ph1)), w,
                     stride=normalize_stride(layer.stride))
        y = torch.clamp_min(y, 0.0)
        if layer.pool_after is not None and \
                min(y.shape[2], y.shape[3]) >= layer.pool_after[0]:
            y = F.max_pool2d(y, *layer.pool_after)
    return y.permute(0, 2, 3, 1).contiguous()


def oracle_check(model: VisionModel, x: torch.Tensor, *, sub_m: int = 8,
                 two_sided: bool = True, collect_stats: bool = True
                 ) -> Tuple[torch.Tensor, List[Dict[str, float]], float]:
    """Sparse kernel path vs dense oracle on one batch: ``(sparse_out,
    stats, rel_err)`` with rel_err = max |out - ref| / max |ref|."""
    out, stats = forward(model, x, sub_m=sub_m, two_sided=two_sided,
                         collect_stats=collect_stats)
    ref = dense_forward(model, x)
    rel = float((out - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    return out, stats, rel


def layer_table(stats: List[Dict[str, float]],
                with_paper: bool = False) -> List[str]:
    """Formatted per-layer density/skip rows."""
    hdr = (f"  {'layer':>5s} {'shape':>17s} {'map':>6s} {'filter':>7s} "
           f"{'w-chunk':>8s} {'skipped':>8s}")
    if with_paper:
        hdr += f" {'map(paper)':>11s} {'filt(paper)':>12s}"
    rows = [hdr]
    for s in stats:
        row = (f"  {s['layer']:5d} {s['kh']}x{s['kh']}x{s['cin']:4d}"
               f"->{s['cout']:4d}  {s['map_scalar_density']:6.3f} "
               f"{s['filter_scalar_density']:7.3f} "
               f"{s['filter_chunk_density']:8.3f} "
               f"{s['skipped_tile_frac']:8.3f}")
        if with_paper:
            row += (f" {s['paper_map_density']:11.3f} "
                    f"{s['paper_filter_density']:12.3f}")
        rows.append(row)
    return rows


def schedule_summary(stats: List[Dict[str, float]]) -> Dict[str, float]:
    """Network totals of the schedule counters, the §3.2 combining factor
    and the grid compaction."""
    tot = {k: float(sum(s[k] for s in stats)) for k in
           ("scheduled_steps", "live_chunk_steps", "flush_only_steps",
            "dense_grid_steps", "static_scheduled_steps",
            "schedule_requests", "schedule_fetches")}
    tot["combine_factor"] = (tot["schedule_requests"]
                             / max(tot["schedule_fetches"], 1e-9))
    tot["grid_compaction"] = (1.0 - tot["scheduled_steps"]
                              / max(tot["dense_grid_steps"], 1e-9))
    return tot


def measured_densities(stats: List[Dict[str, float]]
                       ) -> Tuple[float, float]:
    """MAC-weighted network filter / map scalar densities."""
    macs = np.array([s["macs"] for s in stats])
    fd = float((macs * [s["filter_scalar_density"] for s in stats]).sum()
               / macs.sum())
    md = float((macs * [s["map_scalar_density"] for s in stats]).sum()
               / macs.sum())
    return fd, md
