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
leading ``None``.

The bound half ties specs to a live ``DeviceMesh``:

* :func:`placements` — one DTensor placement per mesh dim for a spec
  (``Shard(d)`` where tensor dim ``d`` names the dim, ``Replicate()``
  elsewhere), refusing what DTensor would silently lay out otherwise.
* :class:`NamedSharding` — the record ``(mesh, spec, placements)``, the
  port's counterpart of ``jax.sharding.NamedSharding``.
* :func:`param_shardings` / :func:`cache_shardings` — those records for a
  params tree and a decode cache.
* :func:`distribute_tree` / :func:`gather_tree` — each rank keeps its own
  slice as a ``DTensor`` (nothing crosses the wire), and back to full
  tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist import axis_names, axis_sizes, dp_axes, tp_axes
from repro_torch.tree import map_tree, map_tree_with_path

# leaf names sharded column-parallel (output-feature dim on TP axes)
_COL = {"wq", "wk", "wv", "w_in", "w_gate", "in_proj",
        "w_r", "w_k", "w_v", "w_g", "w_w"}
# leaf names sharded row-parallel (input-feature dim on TP axes)
_ROW = {"wo", "w_out", "out_proj", "w_o"}
# MoE expert-stacked weights: shard the expert dim (expert parallelism)
_MOE_EXPERT = {"w_in", "w_out", "w_gate"}


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


def make_rules(mesh, n_heads: int, n_kv_heads: int) -> Rules:
    """Head-count-aware rules for ``mesh``: on a factored model axis
    attention tensors shard on the largest axis prefix whose product
    divides the head count; one unfactored ``model`` axis is the
    baseline (everything shards on it)."""
    sizes = axis_sizes(mesh)
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
            sizes = axis_sizes(mesh)
            if len(tp) == 1 and max_len % sizes[tp[0]] == 0:
                entries[2] = tp[0]
    return P(*entries)


def cache_shardings(mesh, abs_cache, batch: int,
                    rules: Optional[Rules] = None):
    """:class:`NamedSharding` tree for a decode cache (the port's layout,
    ``M.init_cache``: one entry per period, leaves without the reference's
    leading periods axis). Each leaf gets :func:`cache_spec` of its
    reference shape, less the periods entry; the batch dim is checked
    against the declared runtime ``batch``, the rest against the leaf's
    shape, and any entry that does not divide falls back to replicated."""
    sizes = axis_sizes(mesh)

    def one(path, leaf):
        shape = (1,) + tuple(leaf.shape)             # the reference's layout
        max_len = shape[2] if len(shape) >= 3 else 0
        spec = cache_spec(mesh, max_len, str(path[-1]), len(shape), rules)
        entries = list(spec)[1:]
        for i, e in enumerate(entries):
            if e is None:
                continue
            extent = batch if i == 0 else shape[i + 1]
            if extent % math.prod(sizes[a] for a in _axes(e)):
                entries[i] = None
        return NamedSharding.of(mesh, P(*entries), leaf.shape)

    return map_tree_with_path(one, abs_cache)


# ---------------------------------------------------------------------------
# the bound half: specs on a live DeviceMesh
# ---------------------------------------------------------------------------
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: PartitionSpec, shape: Optional[Sequence[int]]
               = None) -> tuple:
    """One DTensor placement per dim of ``mesh`` for ``spec``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d``'s entry names,
    ``Replicate()`` on the rest.

    DTensor nests a tensor dim's shards in mesh-dim order, so an entry
    naming several axes must list them in that order (else it would be
    another layout): refused, as is an axis named twice. Given the tensor's
    ``shape``, a dim that its axes do not divide is refused too (DTensor
    would shard it unevenly; the rules never shard one)."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: the mesh has no dim {a!r} "
                                 f"(dims {names})")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: entry {entry} lists mesh dims out of "
                             f"the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh dim {names[i]!r} named "
                                 "twice")
            out[i] = Shard(d)
        if shape is not None and axes:
            n = math.prod(sizes[a] for a in axes)
            if d >= len(shape) or shape[d] % n:
                raise ValueError(
                    f"{spec}: dim {d} of {tuple(shape)} does not divide "
                    f"over {axes} ({n} ranks)")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: ``(mesh, spec, placements)``, the port's
    ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: PartitionSpec
    placements: tuple

    @classmethod
    def of(cls, mesh, spec: PartitionSpec,
           shape: Optional[Sequence[int]] = None) -> "NamedSharding":
        return cls(mesh, spec, placements(mesh, spec, shape))


def replicated(mesh) -> NamedSharding:
    """Every mesh dim replicated."""
    return NamedSharding.of(mesh, P())


def param_shardings(mesh, abs_params, fsdp: bool = False,
                    rules: Optional[Rules] = None):
    """:class:`NamedSharding` tree for ``abs_params`` on ``mesh``.

    Without ``rules`` the baseline rules of the mesh's dim names, with
    exact divisibility against its extents (given ``rules`` get the sizes
    when they lack them). Truthy ``fsdp`` shards one free dim of every
    matrix over the full ``data`` extent (no partial factor)."""
    sizes = axis_sizes(mesh)
    if rules is None:
        tp = tp_axes(mesh)
        rules = Rules(tp=tp, q_axes=tp, kv_axes=tp, sizes=sizes)
    elif rules.sizes is None:
        rules = dataclasses.replace(rules, sizes=sizes)
    fsdp_n = sizes.get("data", 1) if fsdp else 0
    specs = param_specs(abs_params, fsdp=fsdp_n, rules=rules)
    # the params drive the walk, so each spec (a tuple) arrives whole
    return map_tree(
        lambda leaf, spec: NamedSharding.of(mesh, spec, leaf.shape),
        abs_params, specs)


def local_slices(mesh, placements_: Sequence, shape: Sequence[int]
                 ) -> Tuple[slice, ...]:
    """This rank's block of a tensor of global ``shape`` under
    ``placements_`` on ``mesh``, as one slice per dim: the mesh dims split
    a tensor dim in mesh-dim order, as DTensor nests its shards (even
    splits only, :func:`placements` refuses the rest)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    start = [0] * len(shape)
    length = list(shape)
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if length[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide over {n} ranks")
            length[pl.dim] //= n
            start[pl.dim] += coord[i] * length[pl.dim]
    return tuple(slice(s, s + n) for s, n in zip(start, length))


def local_shape(mesh, placements_: Sequence, shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """Each rank's block shape of a tensor of global ``shape`` under
    ``placements_`` (even splits, as :func:`placements` allows), from the
    mesh's extents alone: a stub mesh serves."""
    sizes = list(axis_sizes(mesh).values())
    out = list(shape)
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            out[pl.dim] //= sizes[i]
    return tuple(out)


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor of
    ``sharding``: this rank keeps a copy of its own block, bit for bit;
    no collective runs."""
    local = t[local_slices(sharding.mesh, sharding.placements, t.shape)]
    return DTensor.from_local(local.clone(), sharding.mesh,
                              sharding.placements, run_check=False)


def placed_zeros(sharding: NamedSharding, shape: Sequence[int],
                 dtype: torch.dtype, device) -> DTensor:
    """A zeroed DTensor of global ``shape`` in ``sharding``: each rank
    allocates only its own block (nothing on the meta device)."""
    block = local_slices(sharding.mesh, sharding.placements, shape)
    local = torch.zeros([s.stop - s.start for s in block], dtype=dtype,
                        device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def distribute_tree(tree, shardings):
    """:func:`distribute` leaf by leaf (``shardings`` a tree of
    :class:`NamedSharding` shaped as ``tree``)."""
    return map_tree(distribute, tree, shardings)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor made replicated on every mesh dim (partial sums reduced,
    shards gathered); a plain tensor unchanged."""
    if not isinstance(x, DTensor):
        return x
    rep = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == rep else x.redistribute(
        x.device_mesh, rep)


def gather_tree(tree):
    """Every DTensor leaf as its full tensor (an all-gather where it is
    sharded, a sum where it is partial); other leaves as they are."""
    return map_tree(lambda t: t.full_tensor()
                    if isinstance(t, DTensor) else t, tree)
