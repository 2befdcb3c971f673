"""Mesh construction (port of ``repro.launch.mesh``): the reference's
production meshes and the small debug mesh, as
``torch.distributed.device_mesh.DeviceMesh`` objects built by
:func:`repro_torch.vision.mesh.device_mesh`.

A mesh is one process per rank: each call joins the world ``torchrun``
set up (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` in the environment), or
starts a one-rank world in this process for a mesh of one rank; a mesh
larger than the world raises. ``device`` names the backend: NCCL on the
card (the default), gloo on the CPU.

Single pod: (data=16, model=16), 256 ranks; multi-pod adds a leading
pure data-parallel ``pod`` dim: (pod=2, data=16, model=16), 512 ranks.
``split_model`` factors the model dim into (model1=8, model2=2), so that
head-structured tensors shard on an axis prefix that divides their head
count (``dist.partitioning.make_rules``).
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.vision.mesh import device_mesh


def production_shape(*, multi_pod: bool = False, split_model: bool = False):
    """(shape, dim names) of the reference's production mesh."""
    if split_model:
        shape = (2, 16, 8, 2) if multi_pod else (16, 8, 2)
        names = (("pod",) if multi_pod else ()) + ("data", "model1",
                                                    "model2")
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, names


def make_production_mesh(*, multi_pod: bool = False,
                         split_model: bool = False,
                         device="cuda") -> DeviceMesh:
    """The production mesh over the first 256 (512) ranks of the world."""
    shape, names = production_shape(multi_pod=multi_pod,
                                    split_model=split_model)
    return device_mesh(shape, names, device=device)


def make_debug_mesh(model: int = 1, data: int = 1, *,
                    device="cuda") -> DeviceMesh:
    """A small ``(data, model)`` mesh: one rank by default (a one-rank
    world of its own when none is running)."""
    return device_mesh((data, model), ("data", "model"), device=device)
