"""Tree-structured partition specs for params, batches and decode caches:
the spec half of ``repro.dist.partitioning``.

Which tensor dimension lives on which mesh axis, the way BARISTA's buffer
hierarchy decides which operand lives in the wide shared buffers and which
in the narrow private ones:

* :func:`param_specs` — mesh-unaware specs for a whole params tree, with
  optional FSDP (a ``data``-axis shard on one free dim of every matrix).
* :func:`make_rules` / :func:`leaf_spec` — head-count-aware rules for a
  factored model axis (``model1 x model2``): attention tensors shard on the
  largest axis prefix that divides their head count, FFN and vocab keep
  full tensor parallelism.
* :func:`batch_spec` / :func:`image_batch_spec` / :func:`cache_spec` —
  input batches (data-parallel on the leading dim) and decode caches.

These read only a mesh's dim names and extents (``mesh_dim_names`` and
``shape`` of a ``DeviceMesh``, or ``axis_names`` and a name -> extent
``shape`` mapping), so a stub serves as well as a live mesh. The port's
params carry one dict entry per period, not the reference's stacked
leading axis, so a block leaf's spec is the reference's without its
leading ``None``. Binding specs to a live mesh waits for a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.models.model import map_tree_with_path

# leaf names sharded column-parallel (output-feature dim on TP axes)
_COL = {"wq", "wk", "wv", "w_in", "w_gate", "in_proj",
        "w_r", "w_k", "w_v", "w_g", "w_w"}
# leaf names sharded row-parallel (input-feature dim on TP axes)
_ROW = {"wo", "w_out", "out_proj", "w_o"}
# MoE expert-stacked weights: shard the expert dim (expert parallelism)
_MOE_EXPERT = {"w_in", "w_out", "w_gate"}
# data-parallel mesh axis names, outermost first
_DP_NAMES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (sharded over their product). A tuple of one name
    is stored as the name, as ``jax.sharding.PartitionSpec`` reads it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    """Head-aligned sharding rules for one (mesh, architecture) pair:
    ``tp`` the full tensor-parallel axes, ``q_axes``/``kv_axes`` the
    prefixes of ``tp`` dividing the query / KV head counts (empty: replicate),
    ``sizes`` axis name -> extent when known (exact divisibility checks)."""
    tp: Tuple[str, ...]
    q_axes: Tuple[str, ...]
    kv_axes: Tuple[str, ...]
    sizes: Optional[Mapping[str, int]] = None


# mesh-unaware baseline: single megatron-style "model" axis
_BASELINE = Rules(tp=("model",), q_axes=("model",), kv_axes=("model",))


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's dim names (``DeviceMesh.mesh_dim_names``, or a stub's
    ``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError("the mesh has no dim names")
    return tuple(names)


def _axis_sizes(mesh) -> Mapping[str, int]:
    names = axis_names(mesh)
    shape = mesh.shape                   # a tuple, or name -> extent
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in names}
    return {a: int(s) for a, s in zip(names, shape)}


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes of ``mesh``, outermost (pod) first."""
    return tuple(a for a in _DP_NAMES if a in axis_names(mesh))


def tp_axes(mesh) -> Tuple[str, ...]:
    """Tensor-parallel axes of ``mesh`` (``model`` or ``model1, model2``)."""
    return tuple(a for a in axis_names(mesh) if str(a).startswith("model"))


def dp_extent(mesh) -> int:
    """Product of the data-parallel extents (1 without data axes)."""
    sizes = _axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def make_rules(mesh, n_heads: int, n_kv_heads: int) -> Rules:
    """Head-count-aware rules for ``mesh``: on a factored model axis
    attention tensors shard on the largest axis prefix whose product
    divides the head count; one unfactored ``model`` axis is the
    baseline (everything shards on it)."""
    sizes = _axis_sizes(mesh)
    tp = tp_axes(mesh)
    if len(tp) <= 1:
        return Rules(tp=tp, q_axes=tp, kv_axes=tp, sizes=sizes)

    def head_axes(heads: int) -> Tuple[str, ...]:
        pre = list(tp)
        while pre and (heads <= 0 or heads % math.prod(
                sizes[a] for a in pre) != 0):
            pre.pop()
        return tuple(pre)

    return Rules(tp=tp, q_axes=head_axes(n_heads),
                 kv_axes=head_axes(n_kv_heads), sizes=sizes)


def _entry(axes: Sequence[str]):
    """Spec entry: bare name for one axis, tuple for several."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _divides(dim: int, axes: Sequence[str], rules: Rules) -> bool:
    axes = tuple(axes)
    if not axes:
        return False
    if rules.sizes is not None:
        return dim % math.prod(rules.sizes[a] for a in axes) == 0
    return dim % 2 == 0  # sizes unknown: require an even extent at least


def leaf_spec(path, shape: Tuple[int, ...], rules: Optional[Rules] = None
              ) -> PartitionSpec:
    """Spec for one parameter leaf, by tree path (dict keys and list
    indices) and shape."""
    r = rules or _BASELINE
    names = tuple(str(k) for k in path)
    name = names[-1] if names else ""
    nd = len(shape)
    entries: list = [None] * nd

    def put(dim: int, axes: Sequence[str]) -> None:
        if nd > dim >= -nd and _divides(shape[dim], axes, r):
            entries[dim] = _entry(axes)

    if name == "embed":
        put(0, r.tp)                       # vocab-sharded
    elif name == "lm_head":
        put(-1, r.tp)                      # untied head: vocab-sharded
    elif "moe" in names and "shared" not in names:
        if name in _MOE_EXPERT and nd >= 3:
            put(nd - 3, r.tp)              # expert parallelism
    elif name in _COL and nd >= 2:
        axes = r.tp
        if name == "wq":
            axes = r.q_axes
        elif name in ("wk", "wv"):
            axes = r.kv_axes
        put(-1, axes)
    elif name in _ROW and nd >= 2:
        put(-2, r.q_axes if name == "wo" else r.tp)
    return P(*entries)


def _fsdp_spec(spec: PartitionSpec, shape: Tuple[int, ...],
               fsdp: int) -> PartitionSpec:
    """Add a ``data``-axis shard on the largest free dim (ZeRO-3 style)."""
    if fsdp <= 1 or len(shape) < 2:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % fsdp == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim < 0:
        return spec
    entries[best_dim] = "data"
    return P(*entries)


# params subtrees with one entry per period (the reference stacks them)
_STACKED = ("blocks", "enc_blocks")


def param_specs(abs_params, fsdp: int = 0, rules: Optional[Rules] = None):
    """Spec tree matching ``abs_params`` (tensors, meta ones too: only
    their shapes are read). ``fsdp > 1`` also shards one free dim of every
    matrix-shaped leaf over ``data``.

    A leaf of period ``p`` of ``blocks``/``enc_blocks`` gets the spec the
    reference gives its stacked leaf ``[periods, ...]``, less the leading
    entry (the periods axis, which the rules never shard): so FSDP treats a
    period's vector as the reference treats the stacked matrix of them."""
    periods = {k: len(abs_params[k]) for k in _STACKED
               if isinstance(abs_params.get(k), (list, tuple))}

    def one(path, leaf):
        shape = tuple(leaf.shape)
        stacked = len(path) > 1 and path[0] in periods and \
            isinstance(path[1], int)
        if stacked:
            path = path[:1] + path[2:]
            shape = (periods[path[0]],) + shape
        spec = leaf_spec(path, shape, rules)
        if fsdp:
            spec = _fsdp_spec(spec, shape, int(fsdp))
        if stacked:
            if spec[0] is not None:
                raise ValueError(f"{path}: the rules shard the periods axis")
            spec = P(*spec[1:])
        return spec

    return map_tree_with_path(one, abs_params)


# ---------------------------------------------------------------------------
# batches and decode caches
# ---------------------------------------------------------------------------
def batch_spec(mesh) -> PartitionSpec:
    """Spec for a [B, S] token batch: batch over the data-parallel axes."""
    return P(dp_axes(mesh) or None, None)


def image_batch_spec(mesh) -> PartitionSpec:
    """Spec for a [B, H, W, C] image batch: whole images over the
    data-parallel axes (per-image work lists stay device-local, which keeps
    sharded outputs bitwise equal to the single-device forward)."""
    return P(dp_axes(mesh) or None, None, None, None)


_ATTN_CACHE = ("k", "v", "cross_k", "cross_v")


def cache_spec(mesh, max_len: int, name: str, ndim: int,
               rules: Optional[Rules] = None) -> PartitionSpec:
    """Spec for one decode-cache leaf of the reference's layout
    ([periods, B, S_max, H_kv, d_head] for attention K/V): batch
    data-sharded; under ``rules`` the KV-head dim on ``kv_axes``; the
    baseline shards the sequence dim on an unfactored ``model`` axis."""
    entries: list = [None] * ndim
    dp = dp_axes(mesh)
    if ndim >= 2 and dp:
        entries[1] = tuple(dp)
    if name in _ATTN_CACHE and ndim >= 5:
        if rules is not None:
            if rules.kv_axes:
                entries[3] = tuple(rules.kv_axes)
        else:
            tp = tp_axes(mesh)
            sizes = _axis_sizes(mesh)
            if len(tp) == 1 and max_len % sizes[tp[0]] == 0:
                entries[2] = tp[0]
    return P(*entries)
