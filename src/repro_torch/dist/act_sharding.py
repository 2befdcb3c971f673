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

:func:`settle` takes each block branch's output before its residual add:
a row-parallel matmul's partial sum is reduced there (to the spec's
placements under the context, else replicated), in the forward and, for
the gradient, in the backward.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.dist import axis_sizes, dp_axes, tp_axes
from repro_torch.dist import partitioning as part

# the innermost context wins; the launchers install one
_STACK: List[Tuple[object, "part.PartitionSpec"]] = []


def sp_spec(mesh) -> "part.PartitionSpec":
    """[B, S, D] sequence-parallel spec: batch on the data dims, sequence
    on the model dims, features replicated."""
    return part.PartitionSpec(tuple(dp_axes(mesh)) or None,
                              tuple(tp_axes(mesh)) or None, None)


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
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _target(x):
    """The ambient spec's placements for ``x``, or None where no context
    is installed or the spec cannot tile it."""
    if not _STACK or not isinstance(x, DTensor):
        return None
    mesh, spec = _STACK[-1]
    if x.ndim != len(spec):
        return None
    if x.ndim >= 2 and x.shape[1] == 1:
        return None       # decode: one position cannot be sequence-sharded
    for dim, entry in zip(x.shape, spec):
        if dim % _extent(mesh, entry):
            return None
    return part.placements(mesh, spec, x.shape)


def constrain_residual(x):
    """``x`` redistributed to the ambient spec's placements, or ``x``
    itself where no context is installed or the spec cannot tile it."""
    want = _target(x)
    if want is None or tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


class _GradIn(torch.autograd.Function):
    """Identity forward; the gradient brought to ``placements`` (its
    partial sums reduced) in the backward."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def settle(y):
    """A block branch's output ``y`` (attention, FFN, Mamba, RWKV) before
    its residual add: a pending partial sum (a row-parallel matmul's) is
    reduced, to the ambient spec's placements where it applies (a
    reduce-scatter), else to replicated (an all-reduce), so the stream
    never stays partial; the backward reduces the stream's gradient the
    same way before it enters the branch (Megatron's pair of all-reduces).
    Left partial, the next norm keeps a value (or a gradient) partial and
    DTensor feeds the next matmul by gathering its weight: every model
    rank would then compute the whole product. Anything else
    unchanged."""
    if not isinstance(y, DTensor) or not any(
            isinstance(pl, Partial) for pl in y.placements):
        return y
    want = _target(y)
    if want is None:
        want = tuple(Replicate() if isinstance(pl, Partial) else pl
                     for pl in y.placements)
    return _GradIn.apply(y.redistribute(y.device_mesh, want), want)
