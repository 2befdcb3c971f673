"""Distribution substrate on ``torch.distributed`` (port of ``repro.dist``).

The paper scales a sparse accelerator by hierarchical buffering, request
combining across levels, and round-robin balance between clusters. Over a
``torch.distributed.device_mesh.DeviceMesh`` (one process per rank, one
device per process; gloo on the CPU, NCCL on the card) those become:

* :mod:`repro_torch.dist.partitioning` — which tensor dims live on which
  mesh axis, as trees of :class:`~repro_torch.dist.partitioning.
  PartitionSpec` (the spec half: mesh-unaware rules that read only a mesh's
  dim names and extents).
* :mod:`repro_torch.dist.collective_matmul` — ring all-gather and
  reduce-scatter matmuls over ``isend``/``irecv`` hops, and the ring
  all-gather of per-rank output slabs with their occupancy piggybacked
  (the §3.2 snarfing analog across devices).
* :mod:`repro_torch.dist.compression` — the two-stage mean over the
  ``data`` then ``pod`` groups with a bf16 wire between pods (telescoping
  request combining applied to gradient reduction).
* :mod:`repro_torch.dist.elastic` — mesh planning, straggler detection and
  failure simulation (host numpy).

A mesh's dim names and extents are read here (:func:`axis_names`,
:func:`axis_sizes`, :func:`dp_axes`, :func:`tp_axes`, :func:`dp_extent`),
from a ``DeviceMesh`` or a stub with ``axis_names`` and ``shape``. A
tensor on the card travels only through an NCCL group: a gloo group given
a CUDA tensor raises (:func:`check_group`), nothing falls back.
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
import torch.distributed as dist

__all__ = ["axis_names", "axis_sizes", "check_group", "collective_matmul",
           "compression", "dp_axes", "dp_extent", "elastic", "partitioning",
           "tp_axes"]

# data-parallel mesh axis names, outermost first
_DP_NAMES = ("pod", "data")


def check_group(group, tensor: torch.Tensor) -> None:
    """Refuse a collective whose backend does not serve ``tensor``'s
    device: a CUDA tensor needs an NCCL group (gloo would stage it through
    the host), a CPU tensor a gloo group."""
    backend = str(dist.get_backend(group)).lower()
    if tensor.is_cuda and backend != "nccl":
        raise ValueError(f"a CUDA tensor travels through an NCCL group, got "
                         f"a {backend} group")
    if not tensor.is_cuda and backend != "gloo":
        raise ValueError(f"a {tensor.device} tensor travels through a gloo "
                         f"group, got a {backend} group")


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's dim names (``DeviceMesh.mesh_dim_names``, or a stub's
    ``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError("the mesh has no dim names")
    return tuple(names)


def axis_sizes(mesh) -> Mapping[str, int]:
    """Mesh dim name -> extent."""
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
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))
