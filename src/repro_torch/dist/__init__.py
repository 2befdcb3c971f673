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

A tensor on the card travels only through an NCCL group: a gloo group
given a CUDA tensor raises (:func:`check_group`), nothing falls back.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["check_group", "collective_matmul", "compression", "elastic",
           "partitioning"]


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
