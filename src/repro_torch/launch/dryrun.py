"""Production dry run (port of ``repro.launch.dryrun``): every (architecture
x input shape) cell's sharded train, prefill or decode step run at full
size on the production meshes, on meta tensors in a fake world, with each
rank's memory, FLOPs and collectives recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a]
        [--shape s] [--mesh single|multi|both] [--out DIR] [--opt]
        [--microbatches M] [--remat-group G] [--rank R]

It proves the distribution config coherent, as the reference's does: a
placement that does not tile, an op DTensor has no rule for, or a
collective that does not fit the mesh raises here. Nothing is allocated
and no card is needed.

**The world.** A process group of the ``fake`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``) of 256 ranks
(512 with the multi-pod mesh) in this one process: collectives move
nothing and return tensors of the right shapes. The production mesh
(``launch.mesh.make_production_mesh``; ``--opt`` factors the model dim
into (8, 2)) is built on it once per layout, its set-up timed apart from
the cells. Each cell runs as rank 0 (``--rank R`` another rank: the local
shapes, and so the bytes and FLOPs, are that rank's).

**A cell.** The full config's params (``M.abstract_params``) become
DTensors of ``param_shardings`` (FSDP, microbatches and remat group from
:data:`ARCH_TUNE`, the reference's, copied as they are) whose local
shards are meta tensors of each rank's shape; moments, batches and the
decode cache likewise (``adamw.opt_shardings``, ``batch_spec``,
``cache_shardings``). The three kinds run the port's own step functions:

* ``train``: ``make_train_step`` (donated, as the reference donates);
* ``prefill``: ``make_prefill_fn``'s last-position logits
  (``flash_chunk=1024`` under ``--opt`` for the attention models without
  a frontend, as the reference has it);
* ``decode``: one ``make_serve_step`` on a placed cache of ``seq_len``
  rows (the encoder-decoder's cross K/V of ``min(seq_len, 4096)``
  frames), the tokens replicated when the batch does not divide the data
  dims (``long_500k``, B = 1).

Under ``--opt`` the SP residuals (``act_sharding``) apply outside decode.
A cell fails the run on a raise or when a leaf of the step's output
leaves its sharding's placements; the others go on.

**What a cell records** (JSON, the reference's keys where one maps):

* ``memory``: ``argument_size_in_bytes`` (this rank's params, moments and
  batch, or params, cache and tokens: exact, from the local shapes),
  ``output_size_in_bytes`` (the local shards the step returns) and
  ``alias_size_in_bytes`` (those of them that are argument storage: the
  donated params and moments, the cache lanes), and
  ``temp_size_in_bytes``: the peak of the bytes that the step's own
  allocations hold at once. It is counted by a ``TorchDispatchMode``
  (:class:`Probe`) that sees every op the rank runs on its local tensors
  and adds each new storage's bytes until the storage is freed (CPython
  frees at the last reference, so the count follows the eager program's
  lifetimes: what autograd saves for the backward, what remat drops).
  ``MemTracker`` would need ``FakeTensorMode`` and tracks modules; the
  port's steps are functions of dicts.
* ``per_device``: ``flops`` (from ``torch.utils.flop_counter``'s formulas
  on the ops run on local tensors only: ``FlopCounterMode`` around a
  DTensor op also counts the op that DTensor's sharding propagation runs
  on fake tensors of the global shapes, so ops with a DTensor or a fake
  argument are skipped); ``collective_bytes``, ``per_op_bytes`` and
  ``per_op_count`` over the ``_c10d_functional`` collectives by the
  reference's kinds, each op's bytes the larger of its operands' and its
  result's. The CPU process group lowers an all-to-all to an all-gather,
  so a redistribution between two shardings of one dim counts as an
  all-gather here.
* ``seconds`` (this container's clock, the cell's build and run) and
  ``fits``: whether the argument plus the peak temporary bytes fit
  :data:`TARGET_BYTES`, an H100 80GB HBM3 less :data:`RESERVE_BYTES`. The
  reference's target is a 16-GB chip (``REFERENCE_CHIP_BYTES``); a cell
  over the port's is listed, not failed.

The reference measures 1- and 2-period variants and extrapolates, since
XLA's cost analysis counts a scan body once. The port runs every layer
eagerly, so each count covers the full depth directly.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ARCHS, SHAPES, load_config
from repro_torch.dist import axis_names, dp_axes, dp_extent
from repro_torch.dist import partitioning as part
from repro_torch.dist.act_sharding import act_sharding, sp_spec
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.serve.engine import (init_cache_on, make_prefill_fn,
                                      make_serve_step)
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten_tree, map_tree

# per-arch training knobs, the reference's (chosen there so each cell fits
# a 16-GB chip): FSDP for the big configs, microbatching and grouped remat
# for the deepest ones
ARCH_TUNE: Dict[str, Dict[str, Any]] = {
    "nemotron_4_340b": dict(fsdp=True, microbatches=16, remat_group=2),
    "jamba_1_5_large_398b": dict(fsdp=True, microbatches=8, remat_group=1),
    "arctic_480b": dict(fsdp=True, microbatches=8, remat_group=1),
    "yi_34b": dict(fsdp=True, microbatches=4, remat_group=1),
    "moonshot_v1_16b_a3b": dict(fsdp=True, microbatches=2, remat_group=1),
    "qwen3_4b": dict(fsdp=False, microbatches=1, remat_group=1),
    "h2o_danube_3_4b": dict(fsdp=False, microbatches=1, remat_group=1),
    "rwkv6_3b": dict(fsdp=False, microbatches=1, remat_group=1),
    "paligemma_3b": dict(fsdp=False, microbatches=1, remat_group=1),
    "seamless_m4t_medium": dict(fsdp=False, microbatches=1, remat_group=1),
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the port's per-rank target: an H100 80GB HBM3 less a reserve for the
# CUDA context, NCCL's buffers and the allocator's fragmentation
CARD_BYTES = 80 * 2**30
RESERVE_BYTES = 4 * 2**30
TARGET_BYTES = CARD_BYTES - RESERVE_BYTES
REFERENCE_CHIP_BYTES = 16 * 2**30          # the reference's v5e chip
DEFAULT_OUT = "experiments/dryrun_torch"


def _kind(name: str) -> Optional[str]:
    """The reference's kind of a ``_c10d_functional`` op (None: not a
    collective, such as ``wait_tensor``)."""
    for key, kind in (("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("permute", "collective-permute")):
        if key in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Probe(TorchDispatchMode):
    """Counts what this rank runs on its local tensors: FLOPs
    (``torch.utils.flop_counter``'s formulas), collective bytes and
    counts by kind, and the live and peak bytes of the storages the ops
    allocate (those in ``known`` excepted: the step's arguments).

    An op with a DTensor argument is handed back to DTensor
    (``NotImplemented``), which runs it as ops on local tensors that come
    through here; an op on or making fake tensors (DTensor's sharding
    propagation at the global shapes) is run and not counted."""

    def __init__(self, known=()):
        super().__init__()
        self.flops = 0
        self.per_op_bytes = {k: 0.0 for k in COLLECTIVES}
        self.per_op_count = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        for t in known:
            self._seen[t.untyped_storage()._cdata] = 0

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, outs) -> None:
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if _is_view(func) or any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        leaves = _flat(args, [])
        if kwargs:
            _flat(kwargs.values(), leaves)
        out = _meta_call(func, args, kwargs, leaves)
        outs = _flat((out,), [])
        if any(isinstance(o, FakeTensor) for o in outs):
            return out           # a factory call in a fake mode
        name = func.name()
        if name.startswith("_c10d_functional"):
            kind = _kind(name)
            if kind is not None:
                size = max(sum(_nbytes(a) for a in leaves
                               if isinstance(a, torch.Tensor)),
                           sum(_nbytes(t) for t in outs
                               if isinstance(t, torch.Tensor)))
                self.per_op_bytes[kind] += float(size)
                self.per_op_count[kind] += 1
        elif func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        self._track(outs)
        return out


def _flat(xs, out: list) -> list:
    """The leaves of nested lists and tuples ``xs``, appended to
    ``out``."""
    for x in xs:
        if type(x) in (list, tuple):
            _flat(x, out)
        else:
            out.append(x)
    return out


# output metadata of functional ops on meta tensors, by the op and its
# arguments' metadata: the dry run repeats each op on the same shapes
# thousands of times (every chunk of every layer), and the meta kernels of
# the elementwise ops are Python (``torch._refs``), ~0.1 ms a call
_META_OUT: Dict[tuple, tuple] = {}
_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.memory_format, torch.layout)


_FUNCTIONAL: Dict[Any, bool] = {}
_VIEW: Dict[Any, bool] = {}


def _is_view(func) -> bool:
    """Whether ``func`` only makes views of its arguments (no storage, no
    FLOPs, no collective: nothing for the probe to count)."""
    got = _VIEW.get(func)
    if got is None:
        schema = func._schema
        got = _VIEW[func] = bool(
            func.namespace == "aten" and schema.returns
            and all(r.alias_info is not None and not r.alias_info.is_write
                    for r in schema.returns)
            and func._overloadpacket not in flop_registry)
    return got


def _functional(func) -> bool:
    """Whether ``func`` returns one new tensor: no argument written, no
    view or alias returned."""
    got = _FUNCTIONAL.get(func)
    if got is None:
        schema = func._schema
        got = _FUNCTIONAL[func] = (
            len(schema.returns) == 1
            and str(schema.returns[0].type) == "Tensor"
            and schema.returns[0].alias_info is None
            and not any(a.alias_info is not None and a.alias_info.is_write
                        for a in schema.arguments))
    return got


def _key(x):
    """A hashable stand-in for an argument's metadata (None: not one the
    cache can key on)."""
    t = type(x)
    if t is torch.Tensor:
        if not x.is_meta:
            return None
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if t in (list, tuple):
        parts = tuple(_key(v) for v in x)
        return None if None in parts else (t, parts)
    if isinstance(x, _SCALARS):
        return (t, x)
    return None


def _meta_call(func, args, kwargs, leaves):
    """``func(*args, **kwargs)``, or for a functional op on meta tensors
    seen before with the same metadata, a new meta tensor of the output's
    recorded shape, strides and dtype (the same result without running
    the meta kernel). Meta tensors hold no values, so an output's metadata
    is a function of the op and its arguments' metadata."""
    if func.namespace != "aten" or not _functional(func):
        return func(*args, **kwargs)
    key = _key(args)
    if key is None:
        return func(*args, **kwargs)
    if kwargs:
        kw = _key(tuple(kwargs.items()))
        if kw is None:
            return func(*args, **kwargs)
        key = (key, kw)
    key = (func, key)
    meta = _META_OUT.get(key)
    if meta is None:
        out = func(*args, **kwargs)
        ins = {a.untyped_storage()._cdata for a in leaves
               if isinstance(a, torch.Tensor)}
        # an output that shares an input's storage (``_unsafe_view``) is
        # an alias the schema does not mark: always run
        _META_OUT[key] = (tuple(out.shape), out.stride(), out.dtype) \
            if type(out) is torch.Tensor and out.is_meta \
            and out.untyped_storage()._cdata not in ins else False
        return out
    if meta is False:
        return func(*args, **kwargs)
    shape, stride, dtype = meta
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def fake_world(world_size: int, rank: int = 0) -> None:
    """Start a fake process group of ``world_size`` ranks as ``rank``
    (this process is every rank; no traffic)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _meta(t: torch.Tensor, sharding: part.NamedSharding) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype in ``sharding`` whose
    local shard is a meta tensor of this rank's shape."""
    return part.placed_zeros(sharding, t.shape, t.dtype, "meta")


def state_bytes(cfg, mesh, *, fsdp: bool = False,
                rules: Optional[part.Rules] = None) -> int:
    """One rank's bytes of the train state of ``cfg`` on ``mesh`` (a live
    mesh or a stub of its names and extents): the params in their
    ``param_shardings`` blocks, AdamW's two fp32 moments in the same
    blocks, and the int32 step counter."""
    abs_p = M.abstract_params(cfg)
    sh = flatten_tree(part.param_shardings(mesh, abs_p, fsdp=fsdp,
                                           rules=rules))
    total = 4
    for key, t in flatten_tree(abs_p).items():
        n = math.prod(part.local_shape(mesh, sh[key].placements, t.shape))
        total += n * (t.element_size() + 2 * 4)
    return total


def _locals(tree) -> list:
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in _locals(tree))


def _off(tree, shardings) -> list:
    """Keys of the leaves whose placements are not their shardings'."""
    want = flatten_tree(shardings)
    return [k for k, t in flatten_tree(tree).items()
            if tuple(getattr(t, "placements", ())) != want[k].placements]


def _inputs(cfg, shape, mesh) -> Dict[str, DTensor]:
    """The step's batch (the reference's ``input_specs``) as meta
    DTensors: [B, S] ids by ``batch_spec``, [B, S, D] stub embeddings by
    the batch over the data dims."""
    B = shape.global_batch
    text = shape.seq_len - (cfg.frontend_len if cfg.frontend == "vision"
                            else 0)
    spec2 = part.NamedSharding.of(mesh, part.batch_spec(mesh), (B, text))
    spec3 = part.NamedSharding.of(
        mesh, part.P(tuple(dp_axes(mesh)), None, None))
    ids = torch.empty((B, text), dtype=torch.long, device="meta")
    out = {"tokens": _meta(ids, spec2)}
    if shape.kind == "train":
        out["labels"] = _meta(ids, spec2)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = _meta(torch.empty(
            (B, cfg.frontend_len, cfg.d_model), device="meta"), spec3)
    if cfg.encoder_layers:
        out["src_embeds"] = _meta(torch.empty(
            (B, shape.seq_len, cfg.d_model), device="meta"), spec3)
    return out


def run_cell(arch: str, shape_name: str, mesh, *, opt: bool = False,
             tune_override: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """One cell on ``mesh`` (a ``DeviceMesh`` of the fake world) ->
    its record. Raises on a step that raises or a leaf off its
    placements."""
    t0 = time.perf_counter()
    cfg = load_config(arch)
    shape = SHAPES[shape_name]
    tune = dict(ARCH_TUNE[arch], **(tune_override or {}))
    fsdp = bool(tune["fsdp"])
    rules = part.make_rules(mesh, cfg.n_heads, cfg.n_kv_heads) if opt \
        else None
    p_sh = part.param_shardings(mesh, M.abstract_params(cfg), fsdp=fsdp,
                                rules=rules)
    params = map_tree(_meta, M.abstract_params(cfg), p_sh)
    sp_ctx = act_sharding(mesh, sp_spec(mesh)) \
        if opt and shape.kind != "decode" else contextlib.nullcontext()
    flash = 1024 if (opt and cfg.n_heads and not cfg.frontend) else None
    B = shape.global_batch
    if shape.kind == "train":
        o_sh = adamw.opt_shardings(mesh, p_sh)
        args = (params, adamw.init(params), _inputs(cfg, shape, mesh))
        step = make_train_step(cfg, adamw.AdamWConfig(),
                               microbatches=int(tune["microbatches"]),
                               remat_group=int(tune["remat_group"]),
                               flash_chunk=flash, donate=True)
        want = (p_sh, o_sh)

        def run():
            new_p, new_o, metrics = step(*args)
            return (new_p, new_o), metrics
    elif shape.kind == "prefill":
        batch = _inputs(cfg, shape, mesh)
        args = (params, batch)
        fn = make_prefill_fn(cfg, flash_chunk=flash)
        want = None

        def run():
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            with torch.no_grad():
                return None, fn(params, batch["tokens"], **extras)
    else:
        enc_len = min(shape.seq_len, 4096) if cfg.encoder_layers else 0
        cache, c_sh = init_cache_on(mesh, cfg, B, shape.seq_len,
                                    enc_len=enc_len, rules=rules,
                                    device="meta")
        t_spec = part.batch_spec(mesh) if B % dp_extent(mesh) == 0 \
            else part.P(None, None)
        tok = _meta(torch.empty((B, 1), dtype=torch.long, device="meta"),
                    part.NamedSharding.of(mesh, t_spec, (B, 1)))
        args = (params, cache, tok)
        serve = make_serve_step(cfg)
        want = c_sh

        def run():
            with torch.no_grad():
                nxt, new = serve(params, cache, tok, 0)
            return new, nxt
    arg_locals = _locals(args)
    probe = Probe(arg_locals)
    with sp_ctx, probe:
        checked, rest = run()
    if want is not None:
        off = _off(checked, want)
        if off:
            raise ValueError(f"{len(off)} leaves off their placements: "
                             f"{off[:4]}")
    arg_keys = {t.untyped_storage()._cdata for t in arg_locals}
    outs = _locals((checked, rest))
    memory = {
        "argument_size_in_bytes": float(sum(map(_nbytes, arg_locals))),
        "output_size_in_bytes": float(sum(map(_nbytes, outs))),
        "temp_size_in_bytes": float(probe.peak),
        "alias_size_in_bytes": float(sum(
            _nbytes(t) for t in outs
            if t.untyped_storage()._cdata in arg_keys))}
    names = axis_names(mesh)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": {a: mesh.size(i) for i, a in enumerate(names)},
        "devices": mesh.size(), "rank": dist.get_rank(), "fsdp": fsdp,
        "opt": opt, "microbatches": int(tune["microbatches"]),
        "remat_group": int(tune["remat_group"]),
        "seconds": time.perf_counter() - t0,
        "memory": memory,
        "per_device": {
            "flops": float(probe.flops),
            "collective_bytes": float(sum(probe.per_op_bytes.values())),
            "per_op_bytes": probe.per_op_bytes,
            "per_op_count": probe.per_op_count},
        "target_bytes": float(TARGET_BYTES),
        "fits": memory["argument_size_in_bytes"]
        + memory["temp_size_in_bytes"] <= TARGET_BYTES,
    }


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--opt", action="store_true",
                    help="optimized sharding: factored model dim + "
                         "head-aligned attention + SP residuals + "
                         "head-sharded decode caches")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat-group", type=int, default=None)
    ap.add_argument("--rank", type=int, default=0,
                    help="the fake world's rank whose shards are counted")
    args = ap.parse_args(argv)
    tune_override = {}
    if args.microbatches is not None:
        tune_override["microbatches"] = args.microbatches
    if args.remat_group is not None:
        tune_override["remat_group"] = args.remat_group
    out_dir = os.path.join(args.out, "opt") if args.opt else args.out
    os.makedirs(out_dir, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    multis = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    world = max(math.prod(production_shape(multi_pod=m,
                                           split_model=args.opt)[0])
                for m in multis)
    fake_world(world, args.rank)
    results, failures = {}, []
    try:
        for multi in multis:
            t0 = time.perf_counter()
            mesh = make_production_mesh(multi_pod=multi,
                                        split_model=args.opt, device="cpu")
            print(f"mesh {dict(zip(axis_names(mesh), mesh.shape))} "
                  f"on a fake world of {world} ranks, as rank {args.rank}: "
                  f"built in {time.perf_counter() - t0:.2f} s", flush=True)
            for arch in archs:
                for shape_name in shapes:
                    tag = f"{arch}_{shape_name}_" \
                          f"{'multi' if multi else 'single'}"
                    path = os.path.join(out_dir, tag + ".json")
                    if os.path.exists(path):
                        print(f"[skip] {tag} (cached)", flush=True)
                        continue
                    try:
                        res = run_cell(arch, shape_name, mesh, opt=args.opt,
                                       tune_override=tune_override or None)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        failures.append((tag, f"{type(e).__name__}: "
                                              f"{str(e)[:300]}"))
                        print(f"[FAIL] {tag}: {failures[-1][1]}",
                              flush=True)
                        continue
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    results[tag] = res
                    mem, pd = res["memory"], res["per_device"]
                    kinds = ", ".join(
                        f"{k} {v / 2**20:.1f}"
                        for k, v in pd["per_op_bytes"].items() if v)
                    print(f"[ok] {tag}: {res['seconds']:.1f} s, args/dev "
                          f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB,"
                          f" temp/dev {mem['temp_size_in_bytes'] / 2**30:.2f}"
                          f" GiB, fits {res['fits']}, flops/dev "
                          f"{pd['flops']:.4g}, coll "
                          f"{pd['collective_bytes'] / 2**20:.1f} MiB "
                          f"({kinds})", flush=True)
    finally:
        dist.destroy_process_group()
    if failures:
        print("FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("dry-run complete.")
    return results


if __name__ == "__main__":
    main()
