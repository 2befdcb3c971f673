"""Overlap-friendly collective matmuls over a ring of ``isend``/``irecv``
hops (port of ``repro.dist.collective_matmul``).

BARISTA's snarfing (Section 3.2) lets a node reuse a filter block that
flies past on the shared bus instead of re-requesting it. The collective
analog: instead of an up-front all-gather followed by one big matmul, the
blocks ride a ring and each rank multiplies the block that just arrived
while the next hop is in flight.

Every function here runs on each rank of ``group`` (a process group, such
as ``mesh.get_group("model")``), SPMD: each rank calls it with its own
block and all get the same answer. A hop is one
``torch.distributed.batch_isend_irecv`` of a send to rank ``idx + 1`` and
a receive from rank ``idx - 1`` (group ranks), so after hop ``s`` a rank
holds what rank ``idx - s`` started with. A CUDA tensor needs an NCCL
group (:func:`repro_torch.dist.check_group`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import check_group


def _ring(group) -> Tuple[int, int, int, int]:
    """``(idx, n, next, prev)``: this rank's group rank, the group size
    and the global ranks of its ring neighbours."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    return (idx, n, dist.get_global_rank(group, (idx + 1) % n),
            dist.get_global_rank(group, (idx - 1) % n))


def _hop(sends: Sequence[torch.Tensor], group, nxt: int, prv: int):
    """Start one ring hop of ``sends`` (each to the next rank, a buffer of
    its shape from the previous one); returns ``(received, requests)``."""
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends] + \
        [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
    return recvs, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def allgather_matmul(x_block: torch.Tensor, w_stack: torch.Tensor,
                     group) -> torch.Tensor:
    """Ring all-gather matmul: ``sum_j x_j @ w_stack[j]`` on every rank.

    ``x_block`` [M, K/n] is this rank's column block of x; ``w_stack``
    [n, K/n, N] the replicated weight split into the matching row blocks.
    The x blocks rotate around the ring; each hop's transfer is started
    before the previous block's matmul, so they overlap."""
    check_group(group, x_block)
    idx, n, nxt, prv = _ring(group)
    if w_stack.shape[0] != n:
        raise ValueError(f"w_stack has {w_stack.shape[0]} blocks for a ring "
                         f"of {n}")
    chunk = x_block.contiguous()
    acc = None
    for s in range(n):
        reqs = []
        if s + 1 < n:
            (nxt_chunk,), reqs = _hop([chunk], group, nxt, prv)
        # after s hops this rank holds the block owned by rank idx - s
        part = chunk @ w_stack[(idx - s) % n]
        acc = part if acc is None else acc + part
        _wait(reqs)
        if s + 1 < n:
            chunk = nxt_chunk
    return acc


def ring_allgather(slab: torch.Tensor, group, *,
                   occupancy: Optional[torch.Tensor] = None, axis: int = -1
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Ring all-gather of per-rank slabs, the occupancy piggybacked.

    After a cout-sharded layer rank ``d`` holds its output column slab and
    the matching occupancy bitmask; the next layer needs both in full. The
    slabs ride the ring of :func:`allgather_matmul`, and the occupancy rides
    the same hops (one ``batch_isend_irecv`` carries both), so a consumer
    can compact against a slab's occupancy as it lands. ``n - 1`` hops move
    ``n - 1`` slabs per rank, the all-gather's lower bound. Returns
    ``(full, full_occupancy)``: the slabs concatenated in rank order along
    ``axis`` (the occupancy along its last dim), the same on every rank."""
    check_group(group, slab)
    idx, n, nxt, prv = _ring(group)
    axis = axis % slab.dim()
    parts: List[Optional[torch.Tensor]] = [None] * n
    occs: List[Optional[torch.Tensor]] = [None] * n
    chunk = slab.contiguous()
    occ_chunk = occupancy.contiguous() if occupancy is not None else None
    parts[idx], occs[idx] = chunk, occ_chunk
    for s in range(1, n):
        sends = [chunk] + ([occ_chunk] if occ_chunk is not None else [])
        recvs, reqs = _hop(sends, group, nxt, prv)
        _wait(reqs)
        chunk = recvs[0]
        owner = (idx - s) % n            # after s hops: rank idx - s's slab
        parts[owner] = chunk
        if occ_chunk is not None:
            occ_chunk = recvs[1]
            occs[owner] = occ_chunk
    full = torch.cat(parts, dim=axis)
    focc = torch.cat(occs, dim=-1) if occupancy is not None else None
    return full, focc


def exchange_overlap_fraction(walk_steps: int, num_devices: int,
                              hop_cost_steps: float = 1.0) -> float:
    """Modelled fraction of the ring exchange hidden under the work-list
    walk: a barrier all-gather stalls for all ``D - 1`` hops; on the ring
    the exposed cost is ``max(0, hops * c - walk)`` for a per-hop cost
    ``c`` in walk-step units."""
    hops = max(num_devices - 1, 0)
    if hops == 0:
        return 1.0
    total = hops * float(hop_cost_steps)
    exposed = max(0.0, total - float(walk_steps))
    return 1.0 - exposed / total


def matmul_reducescatter(x_block: torch.Tensor, w_block: torch.Tensor,
                         group) -> torch.Tensor:
    """``x @ w`` with the output sharded along its last dim.

    ``x_block`` [M, K/n] column-sharded, ``w_block`` [K/n, N] row-sharded:
    the local partial product is exact up to the cross-rank sum, which a
    ring reduce-scatter performs over column blocks: at each of ``n - 1``
    hops a rank adds its own partial of the block in flight and passes the
    sum on, so rank ``idx`` ends with the full sum of column block ``idx``
    [M, N/n] and no rank holds the whole output."""
    check_group(group, x_block)
    idx, n, nxt, prv = _ring(group)
    partial = x_block @ w_block
    if partial.shape[-1] % n:
        raise ValueError(f"N={partial.shape[-1]} does not split over {n} "
                         f"ranks")
    blocks = [b.contiguous() for b in torch.chunk(partial, n, dim=-1)]
    acc = blocks[(idx - 1) % n]
    for s in range(n - 1):
        (got,), reqs = _hop([acc], group, nxt, prv)
        _wait(reqs)
        # the block in flight to this rank after hop s
        acc = got + blocks[(idx - s - 2) % n]
    return acc
