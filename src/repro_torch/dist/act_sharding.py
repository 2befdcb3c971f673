"""Sequence-parallel residuals (port of ``repro.dist.act_sharding``).

BARISTA colours its output buffers so that a compute node can start the
next input map without waiting for its siblings to drain the previous one
(paper Section 3.3.1). The software analog: between transformer blocks the
residual stream lives sequence-sharded over the tensor-parallel dims, so a
tensor-parallel boundary becomes a reduce-scatter and an all-gather instead
of an all-reduce.

The plumbing is ambient: :func:`act_sharding` installs a (mesh, spec)
context and ``models/model.py`` calls :func:`constrain_residual` on the
stream after every block. Under the context a ``DTensor`` stream
``[B, S, D]`` is redistributed to the spec's placements. Outside it, on a
plain tensor, on a decode step (S = 1), on a tensor of another rank and on
extents the spec does not divide, the call returns its argument
unchanged, so the solo and the sharded paths share one model.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Tuple

from torch.distributed.tensor import DTensor

# a module import: models.model imports this module, and partitioning
# imports models.model
from repro_torch.dist import partitioning as part

# the innermost context wins; the launchers install one
_STACK: List[Tuple[object, "part.PartitionSpec"]] = []


def sp_spec(mesh) -> "part.PartitionSpec":
    """[B, S, D] sequence-parallel spec: batch on the data dims, sequence
    on the model dims, features replicated."""
    return part.PartitionSpec(tuple(part.dp_axes(mesh)) or None,
                              tuple(part.tp_axes(mesh)) or None, None)


@contextlib.contextmanager
def act_sharding(mesh, spec: "part.PartitionSpec"):
    """Install ``spec`` on ``mesh`` as the ambient residual constraint."""
    _STACK.append((mesh, spec))
    try:
        yield
    finally:
        _STACK.pop()


def _extent(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    sizes = part.axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def constrain_residual(x):
    """``x`` redistributed to the ambient spec's placements, or ``x``
    itself where no context is installed or the spec cannot tile it."""
    if not _STACK or not isinstance(x, DTensor):
        return x
    mesh, spec = _STACK[-1]
    if x.ndim != len(spec):
        return x
    if x.ndim >= 2 and x.shape[1] == 1:
        return x          # decode: one position cannot be sequence-sharded
    for dim, entry in zip(x.shape, spec):
        if dim % _extent(mesh, entry):
            return x
    want = part.placements(mesh, spec, x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
