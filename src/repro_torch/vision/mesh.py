"""Mesh-sharded sparse vision runtime on ``torch.distributed`` (port of
``repro.vision.mesh``).

The paper scales two-sided sparsity by splitting the array into clusters
that round-robin filter chunks and snarf operands off the shared bus
(Sections 3.2 and 4). Here the clusters are ranks of a
``torch.distributed.device_mesh.DeviceMesh`` (one process per rank, one
device per process: ``cuda:<local rank>`` over NCCL, or the CPU over gloo),
twice over:

* **data axis** — whole images shard across ranks (:func:`data_mesh` +
  ``compile_forward(mesh=...)``): each rank runs the forward on its own
  ``B / D`` rows of the batch, then every rank gathers all rows in rank
  order (:func:`shard_forward`). Per-image work lists never cross images,
  so the gathered output is bitwise the single-device forward's.
* **model axis** — one layer's packed filter chunks shard by output chunk
  group (:func:`cout_sharded_spmm`): the pack-time balance
  (``sparsity.conv.mesh_shard_assignment``) gives each rank a contiguous
  run of row blocks with balanced step counts; each rank walks its own
  schedule (``worklist_spmm_padded``: the walker kernel over its local
  work list on the card) and the column slabs ride the ring all-gather
  (``dist.collective_matmul.ring_allgather``) with the next layer's
  occupancy bitmask on the same hops.

A mesh of one rank degenerates to the plain pipeline. A CUDA tensor
travels only through NCCL groups: a gloo world given the card is refused.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist import axis_names, check_group, dp_axes, dp_extent
from repro_torch.dist.collective_matmul import (exchange_overlap_fraction,
                                                ring_allgather)
from repro_torch.kernels.worklist_core import (WorkList, per_shard_steps,
                                               shard_imbalance,
                                               shard_scaling_efficiency,
                                               worklist_spmm_padded)

# how long a rank waits for the others at the world's start
INIT_TIMEOUT_S = 300
# the process-group backend of a fake world (no process and no traffic)
FAKE_BACKEND = "fake"


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _start_world(device: torch.device, ranks: int) -> None:
    """Join the world ``torchrun`` describes (``WORLD_SIZE`` and the rest
    in the environment), or start a one-rank world in this process."""
    timeout = datetime.timedelta(seconds=INIT_TIMEOUT_S)
    backend = _backend(device)
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    elif ranks == 1:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        raise RuntimeError(
            f"a mesh of {ranks} ranks needs a world of processes: launch "
            f"one per rank under torchrun (python -m torch.distributed.run "
            f"--nproc-per-node {ranks} ...)")


def device_mesh(shape: Sequence[int], names: Sequence[str], *,
                device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dim ``names`` over the first
    ``prod(shape)`` ranks of the world, in row-major order.

    With no world yet it joins the one ``torchrun`` set up, or for a mesh
    of one rank starts a one-rank world in-process; a larger mesh without a
    world raises. Every rank of the world calls this (a mesh builds its
    process groups collectively); a rank past the mesh gets a mesh it is
    not part of (:func:`in_mesh` is false there). ``device`` names the
    backend: NCCL for CUDA (the default), gloo for the CPU; a world of the
    other backend is refused. A world of the ``fake`` backend
    (``torch.testing._internal.distributed.fake_pg.FakeStore``: every rank
    is this process, collectives move nothing) stands in for either, as
    the dry run (``repro_torch.launch.dryrun``) uses it."""
    device = torch.device(device)
    shape = tuple(int(s) for s in shape)
    ranks = math.prod(shape)
    if dist.is_initialized():
        backend = str(dist.get_backend()).lower()
        if backend not in (_backend(device), FAKE_BACKEND):
            raise ValueError(f"a {device.type} mesh runs over "
                             f"{_backend(device)}, the world is {backend}")
    elif device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; name the CPU "
                           "(device='cpu') for a gloo mesh")
    else:
        _start_world(device, ranks)
    world = dist.get_world_size()
    if not 1 <= ranks <= world:
        raise ValueError(f"a mesh of {ranks} ranks does not fit a world of "
                         f"{world}")
    grid = torch.arange(ranks, dtype=torch.int).reshape(shape)
    return DeviceMesh(device.type, grid, mesh_dim_names=tuple(names))


def data_mesh(num_devices: Optional[int] = None, *,
              device="cuda") -> DeviceMesh:
    """1-D ``("data",)`` mesh over the first ``num_devices`` ranks (None:
    the whole world, or 1 without one); see :func:`device_mesh`."""
    n = num_devices
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return device_mesh((int(n),), ("data",), device=device)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this process is one of ``mesh``'s ranks."""
    return mesh.get_coordinate() is not None


def dp_index(mesh: DeviceMesh) -> int:
    """This rank's index over the data-parallel dims (pod outermost)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not part of the mesh")
    names = axis_names(mesh)
    idx = 0
    for a in dp_axes(mesh):
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def gather_rows(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every data-parallel rank's ``local`` rows concatenated in
    :func:`dp_index` order, on every rank: all-gathers over the innermost
    data dim first, then each outer one."""
    out = local.contiguous()
    for a in reversed(dp_axes(mesh)):
        g = mesh.get_group(a)
        check_group(g, out)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, out, group=g)
        out = torch.cat(parts)
    return out


def shard_forward(body: Callable[[torch.Tensor], torch.Tensor],
                  mesh: DeviceMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``body`` (the whole-net [B, H, W, C] -> [B, oh, ow, cout] forward)
    data-sharded over ``mesh``: each rank takes its ``B / D`` rows of the
    batch it is given (on the host or its device), runs ``body`` on them and
    gathers every rank's output rows (:func:`gather_rows`), so each rank
    returns the whole batch's output. ``B`` must divide by the data extent
    ``D``. No collective runs inside ``body``: under a CUDA graph only the
    local forward is captured, the gather runs outside it."""
    d = dp_extent(mesh)
    idx = dp_index(mesh)

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % d:
            raise ValueError(f"batch {x.shape[0]} does not divide over the "
                             f"mesh's data extent {d}")
        b = x.shape[0] // d
        return gather_rows(body(x[idx * b:(idx + 1) * b]), mesh)
    return fn


def cout_sharded_spmm(patches: torch.Tensor, vals, wl: WorkList,
                      mesh: DeviceMesh, *, bk: int, bn: int, bm_rows: int,
                      axis: str = "model", occupancy: bool = False):
    """One cout-sharded layer: each rank of ``mesh``'s ``axis`` walks its
    own row blocks' schedule, then the column slabs ride the ring
    all-gather back to full width, with the next layer's occupancy bitmask
    (one bit per ``[bm_rows, bn]`` tile) on the same hops when
    ``occupancy``.

    ``wl`` must carry the contiguous equal-count ``shard_of`` (the
    pack-time cluster assignment after the shard permutation); ``vals`` is
    the whole packed ``[nb, max_nz, bk, bn]`` (each rank reads only its
    ``nb / D`` blocks). Returns the full ``[M, nb * bn]`` output (and the
    ``[M / bm_rows, nb]`` int32 occupancy) on every rank, bitwise equal to
    ``worklist_spmm`` over the whole list."""
    if wl.shard_of is None:
        raise ValueError("worklist has no shard_of — pack with mesh_devices")
    group = mesh.get_group(axis)
    d = dist.get_world_size(group)
    idx = dist.get_rank(group)
    if wl.nb % d:
        raise ValueError(f"nb={wl.nb} not divisible by D={d}")
    nbl = wl.nb // d
    vals = torch.as_tensor(vals, device=patches.device)
    res = worklist_spmm_padded(patches, vals[idx * nbl:(idx + 1) * nbl], wl,
                               idx, d, bk=bk, bn=bn, bm_rows=bm_rows,
                               sub_m=bm_rows, emit_occupancy=occupancy)
    full, focc = ring_allgather(res[0], group,
                                occupancy=res[1] if occupancy else None,
                                axis=-1)
    return (full, focc) if occupancy else full


def mesh_schedule_counters(model, num_devices: int) -> Dict[str, object]:
    """Per-device schedule accounting summed over a model's cached work
    lists (the observable §4 round-robin balance): a layer with a cluster
    assignment adds its per-device steps, one without counts as device 0's
    load; with the balance metrics and the modelled exchange overlap of the
    occupancy ring."""
    per_dev = np.zeros(num_devices, np.int64)
    layers = 0
    for layer in model.layers:
        for wl in layer.conv.wl_cache.values():
            if wl.shard_of is not None:
                per_dev += per_shard_steps(wl, num_shards=num_devices)
            else:
                per_dev[0] += wl.num_steps
            layers += 1
    walk = int(per_dev.max(initial=0))
    return {
        "num_devices": int(num_devices),
        "worklists": layers,
        "per_device_steps": [int(c) for c in per_dev],
        "step_imbalance": shard_imbalance(per_dev),
        "step_scaling_efficiency": shard_scaling_efficiency(per_dev),
        "exchange_overlap_fraction": exchange_overlap_fraction(
            walk, num_devices),
    }


def split_slots(num_slots: int, mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """``(D, num_slots / D)``: the data extent of ``mesh`` (1 without one)
    and the lanes a rank serves, which must divide evenly."""
    d = 1 if mesh is None else dp_extent(mesh)
    if num_slots % d:
        raise ValueError(f"num_slots={num_slots} must divide over the "
                         f"mesh's data extent {d}")
    return d, num_slots // d


def data_counters(wls: List[WorkList], num_devices: int) -> Dict[str, object]:
    """The data-parallel per-device record of an engine whose ranks each
    walk ``wls`` (its local width's work lists) over their own images: the
    same steps on every rank, an exact balance."""
    local = int(sum(wl.num_steps for wl in wls))
    per_dev = np.full(num_devices, local, np.int64)
    return {"num_devices": num_devices,
            "per_device_steps": [int(c) for c in per_dev],
            "step_imbalance": shard_imbalance(per_dev),
            "step_scaling_efficiency": shard_scaling_efficiency(per_dev)}


def agree(obj, mesh: DeviceMesh):
    """``obj`` as the mesh's first rank holds it, on every rank (broadcast
    over each dim's group in turn, innermost first): how the ranks of a
    data-parallel server take one admission decision."""
    for name in reversed(axis_names(mesh)):
        g = mesh.get_group(name)
        if dist.get_world_size(g) > 1:
            box = [obj]
            dist.broadcast_object_list(box, src=dist.get_global_rank(g, 0),
                                      group=g)
            obj = box[0]
    return obj

