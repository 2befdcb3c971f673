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

A model may also be a graph (:func:`build_residual_model`, ResNet-50 with
its shortcuts): each layer names the layer whose output it reads and the
one whose output it adds before its ReLU (:class:`VisionLayer`), and
``model.layers`` stays the flat list of every conv in execution order, so
whatever only counts or packs layers walks it as before. Every forward here
follows the wiring (:func:`walk_maps`); what walks a chain alone raises on
a graph (:func:`require_chain`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.core import simulator as S
from repro_torch.core.sparse import Padding, Stride, normalize_stride, \
    resolve_pads
from repro_torch.kernels.sparse_conv import conv_out_size, sparse_conv2d_nhwc
from repro_torch.kernels.worklist_core import DEFAULT_BM
from repro_torch.sparsity.conv import (PackedConv, build_sparse_chain,
                                       build_sparse_graph)

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
    """One conv layer and its wiring. Its output is the map after
    ``pool_after``, a max-pool of (window, stride) or (window, stride,
    padding). ``src`` is the layer whose output it reads (-1: the image;
    None: the layer before), ``add`` the layer whose output it adds to the
    conv's before the activation (a shortcut; None: none), ``relu`` whether
    the ReLU follows. The defaults make a chain."""
    conv: PackedConv
    stride: Tuple[int, int]
    padding: Padding
    pool_after: Optional[Tuple[int, ...]]
    src: Optional[int] = None
    add: Optional[int] = None
    relu: bool = True


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


def source_of(layers: List[VisionLayer], i: int) -> int:
    """The index of the layer whose output layer ``i`` reads (-1: the
    image)."""
    src = layers[i].src
    return i - 1 if src is None else src


def is_chain(model: VisionModel) -> bool:
    """Whether every layer reads the layer before, adds nothing, ends in a
    ReLU and pools without padding."""
    return all(source_of(model.layers, i) == i - 1 and l.add is None
               and l.relu and pool_geometry(l.pool_after)[2] == 0
               for i, l in enumerate(model.layers))


def require_chain(model: VisionModel, what: str) -> None:
    """Raise ``ValueError`` naming ``what`` where ``model`` is a graph."""
    if not is_chain(model):
        raise ValueError(f"{what} walks a chain of convs, and {model.name} "
                         f"is a graph (a layer reads or adds the output of "
                         f"another than the layer before, runs without "
                         f"ReLU or pools with padding)")


def pool_geometry(pool: Optional[Tuple[int, ...]]) -> Tuple[int, int, int]:
    """(window, stride, padding) of a ``pool_after`` (window 0: none)."""
    if pool is None:
        return 0, 1, 0
    return (int(pool[0]), int(pool[1]), int(pool[2]) if len(pool) > 2 else 0)


def pool_acts(h: int, w: int, window: int, padding: int) -> bool:
    """Whether a max-pool of ``window`` acts on an ``h`` x ``w`` map padded
    by ``padding`` (a map whose padded sides are under the window is left
    as it is)."""
    return window > 0 and min(h, w) + 2 * padding >= window


def pooled_size(h: int, w: int, pool: Optional[Tuple[int, ...]]
                ) -> Tuple[int, int]:
    """The sides after ``pool`` (:func:`pool_acts`)."""
    win, s, p = pool_geometry(pool)
    if not pool_acts(h, w, win, p):
        return h, w
    return (h + 2 * p - win) // s + 1, (w + 2 * p - win) // s + 1


def walk_maps(model: VisionModel, x, layer_fn, pool=None):
    """Run the layers in order on ``x`` (the image, map -1): layer ``i``
    gets ``layer_fn(i, layer, its source's map, its shortcut's map or
    None)`` and its pool (``pool(y, *pool_after)``, by default
    :func:`max_pool`); the result is map ``i``, and the last layer's is
    returned. A map is kept while a later layer still names it and
    dropped once its last reader's conv has run, before that layer's pool:
    on a chain, maps live as long as in a loop over the layers."""
    pool = max_pool if pool is None else pool
    layers = model.layers
    last_read: Dict[int, int] = {}
    for i, layer in enumerate(layers):
        last_read[source_of(layers, i)] = i
        if layer.add is not None:
            last_read[layer.add] = i
    end = len(layers) - 1
    maps = {-1: x}
    for i, layer in enumerate(layers):
        y = layer_fn(i, layer, maps[source_of(layers, i)],
                     None if layer.add is None else maps[layer.add])
        for j in [j for j in maps if j != end and last_read[j] <= i]:
            del maps[j]
        if layer.pool_after is not None:
            y = pool(y, *layer.pool_after)
        if i in last_read or i == end:
            maps[i] = y
        del y
    return maps[end]


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


def build_residual_model(name: str, weights: List[np.ndarray],
                         wiring: List[Dict], *, input_size: int,
                         density: float, num_shards: int = 16,
                         balance_filters: bool = True,
                         pattern: str = "unstructured",
                         micro_ranges: int = 3,
                         device="cuda") -> VisionModel:
    """A graph of convs (a ResNet) from dense ``weights[i]`` [k, k, cin,
    cout] and the wiring of each: ``stride``, ``padding`` (``"SAME"``,
    ``"VALID"`` or explicit ``[[top, bottom], [left, right]]``),
    ``pool_after`` (None, or [window, stride(, padding)]), and the optional
    ``src`` (default the layer before; -1 the image), ``add`` (default none)
    and ``relu`` (default True) of :class:`VisionLayer`. Packed by
    :func:`~repro_torch.sparsity.conv.build_sparse_graph`: one channel
    permutation per map, the maps an add joins sharing one."""
    device = torch.device(device)
    srcs = [w.get("src") for w in wiring]
    adds = [w.get("add") for w in wiring]
    convs = build_sparse_graph(weights, srcs, adds, density=density,
                               num_shards=num_shards,
                               balance_filters=balance_filters,
                               pattern=pattern, micro_ranges=micro_ranges,
                               device=device)
    layers = []
    for wire, conv in zip(wiring, convs):
        pad = wire["padding"]
        if not isinstance(pad, str):
            pad = tuple(tuple(int(v) for v in p) for p in pad)
        pool = wire.get("pool_after")
        stride = wire["stride"]
        stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        layers.append(VisionLayer(conv, stride, pad,
                                  tuple(pool) if pool else None,
                                  src=wire.get("src"), add=wire.get("add"),
                                  relu=bool(wire.get("relu", True))))
    return VisionModel(name, layers, int(input_size), float(density), device)


def route_bucket(buckets: Tuple[int, ...], h: int, w: int) -> int:
    """Canonical shape for an [h, w] image: the smallest bucket that holds
    it (zero-pad up, never past the next canonical shape), or the largest
    bucket when the image exceeds every one (downscale)."""
    if not buckets:
        raise ValueError("need at least one shape bucket")
    side = max(h, w)
    for b in sorted(buckets):
        if side <= b:
            return b
    return max(buckets)


def fit_image(image: np.ndarray, size: int) -> np.ndarray:
    """Canonicalize one [H, W, C] image to [size, size, C].

    An image at or under the bucket is zero-padded bottom/right, its content
    kept exactly (which keeps batched outputs bitwise comparable to solo
    runs). A larger one is resampled down with an antialiased bilinear
    filter (``F.interpolate(..., antialias=True)``, the triangle filter
    widened by the scale that ``jax.image.resize(..., "linear")`` uses), on
    the CPU in fp32."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3:
        raise ValueError(f"image must be [H, W, C], got {img.shape}")
    h, w, c = img.shape
    if h <= size and w <= size:
        return np.pad(img, ((0, size - h), (0, size - w), (0, 0)))
    t = torch.as_tensor(img).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)
    return np.ascontiguousarray(out[0].permute(1, 2, 0).numpy(),
                                dtype=np.float32)


def _tuned_config(layer: VisionLayer, use_tuned: bool):
    """The layer's autotuned tile config when asked for and tuned."""
    c = layer.conv
    return c.tuned.config if (use_tuned and c.tuned is not None) else None


def layer_geometry(model: VisionModel, input_size: int, *,
                   bm_rows: int = DEFAULT_BM,
                   use_tuned: bool = False) -> List[Dict[str, int]]:
    """Static per-layer geometry walk for one input size (host arithmetic
    only): ``oh/ow/m_img/m_pad/bm_rows/mb_per_img`` per layer, each from
    its source's sides (:func:`source_of`), with the pool placement rule of
    :func:`max_pool`; ``use_tuned`` takes each tuned layer's ``bm_rows``."""
    out: List[Dict[str, int]] = []
    sides = {-1: (input_size, input_size)}
    for i, layer in enumerate(model.layers):
        c = layer.conv
        cfg = _tuned_config(layer, use_tuned)
        bm = cfg.bm_rows if cfg else bm_rows
        h, w = sides[source_of(model.layers, i)]
        oh, ow = conv_out_size(h, w, c.kh, c.kw, layer.stride, layer.padding)
        m_img = oh * ow
        m_pad = m_img + (-m_img) % bm
        out.append({"oh": oh, "ow": ow, "m_img": m_img, "m_pad": m_pad,
                    "bm_rows": bm, "mb_per_img": m_pad // bm})
        sides[i] = pooled_size(oh, ow, layer.pool_after)
    return out


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """Channel-wise max-pool of NHWC ``x``, ``padding`` on each side
    (skipped where it would not act: :func:`pool_acts`)."""
    if not pool_acts(x.shape[1], x.shape[2], window, padding):
        return x
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


@graphs.captured
def _forward_layers(model: VisionModel, x: torch.Tensor, *, sub_m: int,
                    two_sided: bool, schedule: str, im2col: str,
                    use_tuned: bool = False) -> torch.Tensor:
    """Every layer through the sparse conv, activations handed on-device
    along the wiring (:func:`walk_maps`; a shortcut is added in the conv's
    flush); ``use_tuned`` runs each tuned layer at its autotuned
    ``bm_rows`` / ``sub_m`` / im2col strategy instead of the global
    knobs."""
    def conv(i, layer, inp, shortcut):
        c = layer.conv
        cfg = _tuned_config(layer, use_tuned)
        y, _ = sparse_conv2d_nhwc(
            inp, c.packed, c.kh, c.kw, c.cout, stride=layer.stride,
            padding=layer.padding, sub_m=cfg.sub_m if cfg else sub_m,
            bm_rows=cfg.bm_rows if cfg else DEFAULT_BM,
            im2col=cfg.im2col if cfg else im2col, two_sided=two_sided,
            fuse_relu=layer.relu, schedule=schedule, layout=c.layout,
            wl_cache=c.wl_cache, residual=shortcut)
        return y
    return walk_maps(model, x, conv)


def compile_forward(model: VisionModel, *, sub_m: int = 8,
                    two_sided: bool = True, schedule: str = "compact",
                    im2col: str = "auto", use_tuned: bool = False,
                    mesh=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The whole-net forward as a closure cached on the model per config.

    Each layer's static work list is built once per row-block count (cached
    on ``PackedConv.wl_cache``) and its schedule arrays are copied to the
    device once (cached on the work list), so a call launches kernels and
    copies no schedule. ``use_tuned`` runs each layer at its cached autotune
    config; the cache key holds those configs, so re-tuning a layer gets a
    new closure.

    ``mesh`` (a ``DeviceMesh`` with a ``data`` dim, this process one of its
    ranks) data-shards the forward (:func:`repro_torch.vision.mesh.
    shard_forward`): each rank runs the forward on its ``B / D`` rows of
    the batch and gathers every rank's output, bitwise the unsharded
    forward's (per-image work lists never cross images).
    """
    key = _forward_key(model, sub_m, two_sided, schedule, im2col, use_tuned)
    if mesh is not None:
        return _sharded(model, mesh, key, lambda: compile_forward(
            model, sub_m=sub_m, two_sided=two_sided, schedule=schedule,
            im2col=im2col, use_tuned=use_tuned))
    fn = model._fwd_cache.get(key)
    if fn is None:
        @torch.no_grad()
        def fn(x: torch.Tensor) -> torch.Tensor:
            return _forward_layers(model, x, sub_m=sub_m,
                                   two_sided=two_sided, schedule=schedule,
                                   im2col=im2col, use_tuned=use_tuned)
        model._fwd_cache[key] = fn
    return fn


def _sharded(model: VisionModel, mesh, key: tuple,
             local: Callable[[], Callable[[torch.Tensor], torch.Tensor]]):
    """The forward ``local()`` builds, data-sharded over ``mesh``
    (:func:`repro_torch.vision.mesh.shard_forward`), cached on the model
    under ``key`` and the mesh object itself: a new mesh over the same ranks
    (a world torn down and started again) gets a new closure, and the
    cached closure holds its mesh, so the id is not reused while cached."""
    from repro_torch.vision.mesh import shard_forward
    key = ("mesh", id(mesh)) + key
    fn = model._fwd_cache.get(key)
    if fn is None:
        fn = model._fwd_cache[key] = shard_forward(local(), mesh)
    return fn


def _forward_key(model: VisionModel, sub_m: int, two_sided: bool,
                 schedule: str, im2col: str, use_tuned: bool) -> tuple:
    """The forward caches' key: the knobs and every layer's tuned config
    (re-tuning a layer gets a new forward and a new graph)."""
    tuned_key = tuple(
        cfg.key() if (cfg := _tuned_config(layer, use_tuned)) else None
        for layer in model.layers)
    return (sub_m, two_sided, schedule, im2col, use_tuned, tuned_key)


def graphed_forward(model: VisionModel, *, sub_m: int = 8,
                    two_sided: bool = True, schedule: str = "compact",
                    im2col: str = "auto", use_tuned: bool = False,
                    mesh=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The whole-net forward of :func:`compile_forward` captured in a CUDA
    graph per input shape: the port's counterpart of the reference's
    jitted ``compile_forward`` (one compiled executable of the whole net).
    Cached on the model under the same key as :func:`compile_forward`'s
    closure, with one :class:`repro_torch.graphs.CapturedGraph` per
    ``(shape, dtype)`` of the input batch.

    The first call of a shape runs the forward eagerly (building the
    layers' work lists and their device copies) and captures it; later
    calls copy the batch (on the host or the card) into the graph's input
    buffer and replay: 13 K1 launches and the pools of VGG16 in one graph
    launch, bitwise what the eager forward gives. With ``im2col="auto"``
    (the default) the tap-layout layers' K1 launches read their input maps
    through the tap-slab operand (im2col tensor copies baked into the
    graph), so the graph holds no patch matrix but the stem's; a layer
    tuned to ``"taps"`` (``use_tuned``) captures its patch matrix instead,
    with bitwise the same output. Returns a new tensor on the model's device;
    the callable's ``graphs`` holds its graphs by shape. On the CPU it is
    the eager forward. The instrumented paths (``forward(collect_stats=
    True)``, ``oracle_check``) read counters to the host and stay eager.

    ``mesh`` data-shards it as :func:`compile_forward` does: each rank
    replays the forward captured at its local width ``B / D``, and the
    gather of the ranks' rows runs after the replay, outside the graph.
    """
    key = ("graph",) + _forward_key(model, sub_m, two_sided, schedule,
                                    im2col, use_tuned)
    if mesh is not None:
        return _sharded(model, mesh, key, lambda: graphed_forward(
            model, sub_m=sub_m, two_sided=two_sided, schedule=schedule,
            im2col=im2col, use_tuned=use_tuned))
    fn = model._fwd_cache.get(key)
    if fn is None:
        body = compile_forward(model, sub_m=sub_m, two_sided=two_sided,
                               schedule=schedule, im2col=im2col,
                               use_tuned=use_tuned)
        per_shape: Dict[tuple, graphs.CapturedGraph] = {}

        def fn(x: torch.Tensor) -> torch.Tensor:
            shape = (tuple(x.shape), x.dtype)
            g = per_shape.get(shape)
            if g is None:
                g = per_shape[shape] = graphs.CapturedGraph(
                    body, model.device,
                    f"{model.name} forward of {tuple(x.shape)}")
            out = g(x)
            return out.clone() if g.replays else out
        fn.graphs = per_shape            # the captured graphs, by shape
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

    By default the cached work-list forward runs (:func:`compile_forward`,
    with ``use_tuned``). ``collect_stats`` runs the instrumented per-layer
    path instead — the dense-grid kernel with its ``count_macs`` counters,
    at the global knobs — and returns one dict per layer with the measured
    densities, the executed vs skippable tile MACs and the compacted
    schedule's step counts.
    """
    if compiled is None:
        compiled = not collect_stats
    if compiled and not collect_stats:
        fn = compile_forward(model, sub_m=sub_m, two_sided=two_sided,
                             schedule=schedule, im2col=im2col,
                             use_tuned=use_tuned)
        return fn(x), []
    stats: List[Dict[str, float]] = []
    bench = S.BENCHMARKS.get(model.name)
    # the paper's layer specs are a chain's
    chain = bench is not None and is_chain(model)

    def conv(i, layer, x, shortcut):
        c = layer.conv
        if collect_stats:
            map_scalar = float((x != 0).float().mean())
        out, aux = sparse_conv2d_nhwc(
            x, c.packed, c.kh, c.kw, c.cout, stride=layer.stride,
            padding=layer.padding, sub_m=sub_m, two_sided=two_sided,
            fuse_relu=layer.relu, emit_occupancy=collect_stats,
            count_macs=collect_stats,
            schedule="dense" if collect_stats else schedule,
            im2col=im2col, layout=c.layout, wl_cache=c.wl_cache,
            compact_activations=collect_stats,
            report_schedule=collect_stats, residual=shortcut)
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
                "paper_map_density": bench.map_density if bench else None,
                "paper_filter_density":
                    bench.filter_density if bench else None,
                "executed_tile_macs": executed,
                "weight_tile_macs": float(weight_tile),
                "dense_tile_macs": float(dense_tile),
                "skipped_tile_frac": 1.0 - executed / max(weight_tile, 1),
                "out_occupancy_density":
                    float(aux["occupancy"].float().mean()),
                "spec_oh": bench.layers[i].oh if chain else None,
            })
        return out
    return walk_maps(model, x, conv), stats


@torch.no_grad()
def dense_forward(model: VisionModel, x: torch.Tensor) -> torch.Tensor:
    """Oracle: the same pruned (fold-permuted) filters through
    ``F.conv2d``, the shortcut's add, the ReLU and pooling along the wiring,
    in full fp32 (TF32 off: cuDNN turns it on for convolutions by
    default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def conv(i, layer, y, shortcut):             # NCHW maps
        c = layer.conv
        w = torch.as_tensor(c.w_dense, device=x.device).permute(3, 2, 0, 1)
        (ph0, ph1), (pw0, pw1) = resolve_pads(tuple(y.shape[2:]), c.kh,
                                              c.kw, layer.stride,
                                              layer.padding)
        y = F.conv2d(F.pad(y, (pw0, pw1, ph0, ph1)), w,
                     stride=normalize_stride(layer.stride))
        if shortcut is not None:
            y = y + shortcut
        return torch.clamp_min(y, 0.0) if layer.relu else y

    def pool(y, window, stride, padding=0):
        if not pool_acts(y.shape[2], y.shape[3], window, padding):
            return y
        return F.max_pool2d(y, window, stride, padding)
    y = walk_maps(model, x.permute(0, 3, 1, 2), conv, pool)
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
