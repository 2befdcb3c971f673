"""Hierarchical gradient reduction: telescoping request combining (port
of ``repro.dist.compression``).

In the paper (Section 3.2) requests for one chunk combine at each level
of the buffer hierarchy, so the narrow upper links carry one telescoped
request instead of many. A gradient mean over a two-level ``(pod, data)``
mesh has the same shape: reduce in fp32 over the fast intra-pod ``data``
group first, then send one bf16 copy per pod over the slow inter-pod
links.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import check_group


def hierarchical_psum(grad: torch.Tensor, mesh, *, pod_axis: str = "pod",
                      data_axis: str = "data",
                      wire_dtype: torch.dtype = torch.bfloat16
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Two-stage mean over ``data`` then ``pod`` of ``mesh`` (a
    ``DeviceMesh`` with both dims); returns ``(mean, stats)`` on every
    rank.

    Stage 1 is an fp32 mean over the ``data`` group. Stage 2 casts the
    per-pod mean to ``wire_dtype`` and all-gathers those values over the
    ``pod`` group (the wire carries ``wire_dtype`` bytes), then sums them
    in fp32 in pod order and divides: the reference's ``psum`` of the
    upcast wire values. ``stats`` records the inter-pod bytes saved."""
    data_g, pod_g = mesh.get_group(data_axis), mesh.get_group(pod_axis)
    check_group(data_g, grad)
    n_data = dist.get_world_size(data_g)
    n_pod = dist.get_world_size(pod_g)
    local = grad.to(torch.float32).clone()
    dist.all_reduce(local, group=data_g)
    local = local / n_data
    wire = local.to(wire_dtype)
    got = [torch.empty_like(wire) for _ in range(n_pod)]
    dist.all_gather(got, wire, group=pod_g)
    total = got[0].to(torch.float32)
    for g in got[1:]:
        total = total + g.to(torch.float32)
    total = total / n_pod
    full_bytes = grad.numel() * torch.finfo(torch.float32).bits // 8
    sent_bytes = grad.numel() * torch.finfo(wire_dtype).bits // 8
    stats = {
        "inter_pod_bytes_fp32": full_bytes,
        "inter_pod_bytes_sent": sent_bytes,
        "compression": full_bytes / sent_bytes,
    }
    return total.to(grad.dtype), stats
