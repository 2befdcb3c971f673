"""BARISTA sparse FFN (port of ``repro.sparsity.sparse_ffn``): run the FFNs
of a model through the two-sided chunk-sparse kernels.

Offline (filters are static for inference, so the pre-processing is
amortized over all inferences):

  1. prune each weight matrix per output channel to a target density,
  2. greedy-balance the hidden channels across ``num_shards`` shards and
     fold the permutation into the output projection's input axis,
  3. pack into the chunk-block-sparse layout (``core.bitmask``).

Online an FFN is two launches: the fused in-projection / activation / gate
kernel (:mod:`repro_torch.kernels.fused_ffn`), then the two-sided output
projection (:mod:`repro_torch.kernels.bitmask_spmm`), whose row skip feeds
on the activation zeros. ``schedule="compact"`` runs the same two launches
from telescoped work lists through the walker
(:mod:`repro_torch.kernels.worklist_core`): eager only, bit for bit the
dense grid's output on the card.

:func:`sparsify_model` packs every FFN of a model's params into
``ffn_sparse`` leaves (``channel_mix_sparse`` for the RWKV channel-mix)
beside the dense weights; the model runs them when ``cfg.sparse_ffn`` is
set. Host packing is numpy, array-equal to the reference for the same
dense weights; the packed leaves live on the params' device in the config
dtype. ``strict=True`` verifies the packed leaves
(:func:`repro_torch.analysis.verify_param_leaves`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import balance, bitmask as bm
from repro_torch.core.sparse import prune_by_magnitude
from repro_torch.kernels import ops
from repro_torch.kernels.worklist_core import activate

# row granularity of the activation-side skip in the serving hot path: one
# live decode lane costs one sub-block of MACs, not the whole 128-row block
SUB_M = 8


def _host(w) -> np.ndarray:
    """A weight as host float32 numpy (tensors leave their device)."""
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


@dataclasses.dataclass
class SparseFFN:
    """Inference-time FFN with block-sparse weights (one transformer block).

    ``w_in``/``w_gate`` are channel-permuted by the greedy balance ``perm``;
    ``w_out`` has the permutation folded into its input axis, so the block
    output equals the unpermuted FFN's.
    """

    w_in: bm.BlockSparseMatrix
    w_out: bm.BlockSparseMatrix
    w_gate: Optional[bm.BlockSparseMatrix]
    act: str
    perm: np.ndarray

    def __call__(self, x: torch.Tensor, *, sub_m: Optional[int] = None,
                 schedule: str = "dense",
                 compact_activations: bool = True) -> torch.Tensor:
        """``schedule="dense"`` runs the predicated kernels; ``"compact"``
        drives both launches from telescoped work lists (eager; the
        schedule is host data), bit for bit the dense grid's output on the
        card. With ``compact_activations`` the schedules also intersect the
        live activation sub-blocks (per-call data); without it the static
        pack-time schedules cache on the packed matrices' ``wl_cache``."""
        gate = self.w_gate
        if schedule == "compact":
            sub = SUB_M if sub_m is None else sub_m
            h = ops.fused_sparse_ffn_wl(
                x, self.w_in.indices, self.w_in.vals,
                gate.indices if gate is not None else None,
                gate.vals if gate is not None else None, act=self.act,
                k_total=self.w_in.shape[0], bk=self.w_in.bk,
                bn=self.w_in.bn, sub_m=sub,
                compact_activations=compact_activations,
                wl_cache=self.w_in.wl_cache)
            return ops.sparse_matmul_packed_wl(
                h, self.w_out.indices, self.w_out.vals,
                k_total=self.w_out.shape[0], bk=self.w_out.bk,
                bn=self.w_out.bn, sub_m=sub,
                compact_activations=compact_activations,
                wl_cache=self.w_out.wl_cache)
        if schedule != "dense":
            raise ValueError(f"unknown schedule {schedule!r}")
        h = ops.fused_sparse_ffn(
            x, self.w_in.indices, self.w_in.vals,
            gate.indices if gate is not None else None,
            gate.vals if gate is not None else None, act=self.act,
            k_total=self.w_in.shape[0], bk=self.w_in.bk, bn=self.w_in.bn,
            sub_m=sub_m)
        # h is sparse after relu-family activations: two-sided pays off here
        return ops.sparse_dense_matmul(h, self.w_out, two_sided=True,
                                       sub_m=sub_m)


def _pad_to(x: np.ndarray, mult: int, axis: int) -> np.ndarray:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


def _prep_matrices(params_ffn: Dict[str, Any], *, density: float,
                   num_shards: int, chunk: int, step: int
                   ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Offline prune -> balance -> fold -> pad for one FFN's matrices.

    Returns chunk-padded dense float32 matrices keyed ``in``/``out``
    (/``gate``) plus the balance permutation.
    """
    w_in = _host(params_ffn["w_in"])
    w_out = _host(params_ffn["w_out"])
    w_gate = params_ffn.get("w_gate")

    # 1. prune (per output channel, Deep-Compression style)
    w_in = w_in * prune_by_magnitude(w_in, density, axis_out=-1)
    w_out = w_out * prune_by_magnitude(w_out, density, axis_out=-1)
    if w_gate is not None:
        w_gate = _host(w_gate)
        w_gate = w_gate * prune_by_magnitude(w_gate, density, axis_out=-1)

    # 2. greedy balance the hidden (F) channels across shards; alternate
    #    direction by `step` (the paper's two fixed permutations)
    dens = balance.filter_density(w_in, axis_out=-1)
    perm = balance.greedy_balance(dens, num_shards, direction=step)

    w_in = w_in[:, perm]
    if w_gate is not None:
        w_gate = w_gate[:, perm]
    # 3. fold: w_out reads its input (F) axis in the same permuted order
    w_out = balance.fold_permutation(w_out, perm, axis_in=0)

    # 4. pad every dim to the chunk so the kernel grid tiles exactly
    mats = {"in": _pad_to(_pad_to(w_in, chunk, 0), chunk, 1),
            "out": _pad_to(_pad_to(w_out, chunk, 0), chunk, 1)}
    if w_gate is not None:
        mats["gate"] = _pad_to(_pad_to(w_gate, chunk, 0), chunk, 1)
    return mats, perm


def build_sparse_ffn(params_ffn: Dict[str, Any], act: str, *,
                     density: float = 0.35, num_shards: int = 16,
                     chunk: int = bm.CHUNK, step: int = 0,
                     device="cuda") -> SparseFFN:
    """Offline pipeline: prune -> balance -> fold -> pack, onto ``device``.

    ``params_ffn`` holds dense ``w_in`` [D, F], ``w_out`` [F, D] and
    optionally ``w_gate`` [D, F] (one block's FFN params).
    """
    mats, perm = _prep_matrices(params_ffn, density=density,
                                num_shards=num_shards, chunk=chunk,
                                step=step)

    def pack(w, pad_to=None):
        return bm.block_sparsify(w, bk=chunk, bn=chunk, pad_to=pad_to,
                                 device=device)

    gate = None
    w_in = pack(mats["in"])
    if "gate" in mats:
        # in/gate share one max_nz so the fused kernel's j axis aligns
        # offline (no runtime repad of the weight tensors)
        gate = pack(mats["gate"])
        mnz = max(w_in.max_nz, gate.max_nz)
        w_in, gate = pack(mats["in"], mnz), pack(mats["gate"], mnz)
    return SparseFFN(w_in, pack(mats["out"]), gate, act, perm)


def dense_reference(ffn: SparseFFN, x: torch.Tensor) -> torch.Tensor:
    """Oracle for a SparseFFN: both matmuls on the densified weights
    (``torch.matmul``), the same activation. Any leading shape."""
    x = F.pad(x, (0, ffn.w_in.shape[0] - x.shape[-1]))
    h = x @ bm.block_densify(ffn.w_in).to(x.dtype)
    g = x @ bm.block_densify(ffn.w_gate).to(x.dtype) \
        if ffn.w_gate is not None else None
    return activate(h, g, ffn.act) @ bm.block_densify(ffn.w_out).to(x.dtype)


# ---------------------------------------------------------------------------
# whole-model sparsification (one packed leaf dict per period)
# ---------------------------------------------------------------------------
def _pack_stacked_ffn(periods: List[Dict[str, Any]], *, density: float,
                      num_shards: int, chunk: int
                      ) -> List[Dict[str, torch.Tensor]]:
    """Sparsify one FFN of every period (``periods[p]`` holds its dense
    ``w_in``/``w_out``/``w_gate``) into packed leaves on the weights'
    device, in their dtype.

    Every period's lists of one role share one ``max_nz`` (in/gate one
    value together, so the fused kernel's j axis aligns offline), as the
    reference's period-stacked leaves do. Each period is packed at its own
    ``max_nz`` and moved to the device as it is made, then padded with
    ``-1`` slots and zero tiles to the shared one: the same arrays as
    packing at the shared ``max_nz``, with one period on the host at a time.
    """
    w0 = periods[0]["w_in"]
    dtype = w0.dtype if isinstance(w0, torch.Tensor) else torch.float32
    device = w0.device if isinstance(w0, torch.Tensor) else "cpu"
    packed = []
    for p, blk in enumerate(periods):
        mats, _ = _prep_matrices(blk, density=density,
                                 num_shards=num_shards, chunk=chunk, step=p)
        per = {}
        for role, m in mats.items():
            s = bm.block_sparsify(m, bk=chunk, bn=chunk, device="cpu")
            per[role] = (s.indices, s.vals.to(device=device, dtype=dtype))
        packed.append(per)
    mnz = {role: max(per[role][0].shape[1] for per in packed)
           for role in packed[0]}
    if "gate" in mnz:
        mnz["in"] = mnz["gate"] = max(mnz["in"], mnz["gate"])
    out = []
    for per in packed:
        leaves = {}
        for role, (idx, vals) in per.items():
            pad = mnz[role] - idx.shape[1]
            leaves[f"{role}_indices"] = F.pad(idx, (0, pad), value=-1) \
                .to(device)
            leaves[f"{role}_vals"] = F.pad(vals, (0, 0, 0, 0, 0, pad))
        out.append(leaves)
    return out


def sparsify_model(params: Dict[str, Any], cfg, *, density: float = 0.35,
                   num_shards: int = 16, chunk: int = bm.CHUNK,
                   strict: bool = False) -> Dict[str, Any]:
    """Offline whole-model pass: prune -> balance -> fold -> pack every
    eligible FFN into two-sided block-sparse form.

    Eligible: the FFNs of the decoder's blocks (``params["blocks"]``) and of
    an encoder-decoder's encoder (``params["enc_blocks"]``), gated or not,
    and every RWKV channel-mix (squared ReLU, the naturally two-sided FFN).
    MoE expert banks keep their own balancing
    (``sparsity.expert_balance``) and stay dense, as do the attention and
    SSM projections, as in the reference.

    Returns new params carrying packed ``ffn_sparse`` /
    ``channel_mix_sparse`` leaves beside the dense weights
    (``params["blocks"][p]["p<i>"]["ffn_sparse"]``, one dict per period);
    the model runs them when ``cfg.sparse_ffn`` is set, so one params
    object serves both paths. With ``density=1.0`` the pass is numerically
    a no-op (pack and balance fold only). On the card the FFN kernels take
    a ``chunk`` that is a multiple of 8, at most 128; another chunk packs
    here but raises ``ValueError`` at the first CUDA launch (the CPU path
    takes any); ``strict=True`` refuses it at pack time instead, with every
    other leaf invariant (:class:`~repro_torch.analysis.AnalysisError`).
    """
    new = dict(params)
    for stack_key in ("blocks", "enc_blocks"):
        if stack_key not in params:
            continue
        blocks = params[stack_key]
        new_blocks = [dict(period) for period in blocks]
        for pk in blocks[0]:
            for src, leaf in (("ffn", "ffn_sparse"),
                              ("channel_mix", "channel_mix_sparse")):
                if src not in blocks[0][pk]:
                    continue
                leaves = _pack_stacked_ffn(
                    [{k: period[pk][src][k]
                      for k in ("w_in", "w_out", "w_gate")
                      if k in period[pk][src]} for period in blocks],
                    density=density, num_shards=num_shards, chunk=chunk)
                for period, sp in zip(new_blocks, leaves):
                    period[pk] = dict(period[pk], **{leaf: sp})
        new[stack_key] = new_blocks
    if strict:
        # local import: repro_torch.analysis imports this module
        from repro_torch.analysis import raise_on_errors, verify_param_leaves
        raise_on_errors(verify_param_leaves(new, d_model=cfg.d_model),
                        "sparsify_model")
    return new


def sparse_ffn_apply(sp: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
                     *, sub_m: Optional[int] = SUB_M, chunk: int = bm.CHUNK,
                     schedule: str = "dense",
                     compact_activations: bool = True,
                     wl_cache: Optional[Dict[str, dict]] = None
                     ) -> torch.Tensor:
    """Run one packed sparse FFN (one period's ``sparsify_model`` leaves) on
    ``x [..., D]`` -> ``[..., D]``: the fused in/gate/activation kernel,
    then the two-sided output projection fed by the activation zeros.
    Output columns are cut back to D (the pack pads D and F to the chunk).

    ``schedule="compact"`` drives both launches from telescoped work lists
    (eager; bit for bit the dense grid's output on the card). The packed
    leaves are plain tensors, so static schedules
    (``compact_activations=False``) cache in a caller-owned ``wl_cache``
    (``{"in": {...}, "out": {...}}``) instead of riding on the leaves.
    """
    D = x.shape[-1]
    k_in = -(-D // chunk) * chunk
    if schedule == "compact":
        sub = SUB_M if sub_m is None else sub_m
        wl_cache = wl_cache if wl_cache is not None else {}
        h = ops.fused_sparse_ffn_wl(
            x, sp["in_indices"], sp["in_vals"], sp.get("gate_indices"),
            sp.get("gate_vals"), act=act, k_total=k_in, bk=chunk, bn=chunk,
            sub_m=sub, compact_activations=compact_activations,
            wl_cache=wl_cache.setdefault("in", {}))
        out = ops.sparse_matmul_packed_wl(
            h, sp["out_indices"], sp["out_vals"], k_total=h.shape[-1],
            bk=chunk, bn=chunk, sub_m=sub,
            compact_activations=compact_activations,
            wl_cache=wl_cache.setdefault("out", {}))
        return out[..., :D]
    if schedule != "dense":
        raise ValueError(f"unknown schedule {schedule!r}")
    h = ops.fused_sparse_ffn(
        x, sp["in_indices"], sp["in_vals"], sp.get("gate_indices"),
        sp.get("gate_vals"), act=act, k_total=k_in, bk=chunk, bn=chunk,
        sub_m=sub_m)
    out = ops.sparse_matmul_packed(
        h, sp["out_indices"], sp["out_vals"], k_total=h.shape[-1], bk=chunk,
        bn=chunk, sub_m=sub_m, two_sided=True)
    return out[..., :D]


def densify(sp: Dict[str, torch.Tensor], role: str, k_total: int,
            chunk: int = bm.CHUNK) -> torch.Tensor:
    """The dense fp32 ``[k_total, nb * chunk]`` weight of one role
    (``"in"``, ``"gate"`` or ``"out"``) of a packed FFN's leaves."""
    idx = sp[f"{role}_indices"]
    return bm.block_densify(bm.BlockSparseMatrix(
        idx, sp[f"{role}_vals"], (k_total, idx.shape[0] * chunk), chunk,
        chunk)).float()


def sparse_ffn_tile_stats(sp: Dict[str, torch.Tensor], x: torch.Tensor,
                          act: str, *, sub_m: Optional[int] = SUB_M,
                          chunk: int = bm.CHUNK) -> Dict[str, torch.Tensor]:
    """Executed / one-sided / dense tile-MAC counts of one packed FFN on
    real activations (no kernel launch), summed over the in-, gate- and
    out-projections; the hidden tensor comes from the densified weights so
    the out-projection sees the true activation zeros.

    Also the work-list schedule counters of the same two launches
    (``scheduled_steps``, ``live_chunk_steps``, ``flush_only_steps``,
    ``dense_grid_steps``) at ``sub_m``-row granularity, and
    ``predicated_grid_steps``, the in-lane sub-block steps the dense grid
    iterates for the same batch. fp32 scalars on ``x``'s device (nothing
    is read to the host: the captured probe runs it).
    """
    D = x.shape[-1]
    k_in = -(-D // chunk) * chunk
    xp = F.pad(x, (0, k_in - D)).float()
    h = xp @ densify(sp, "in", k_in, chunk)
    g = xp @ densify(sp, "gate", k_in, chunk) if "gate_indices" in sp \
        else None
    h = activate(h, g, act)

    totals = ops.sparse_matmul_tile_stats(x, sp["in_indices"], k_total=k_in,
                                          bk=chunk, sub_m=sub_m)
    if "gate_indices" in sp:
        s = ops.sparse_matmul_tile_stats(x, sp["gate_indices"],
                                         k_total=k_in, bk=chunk, sub_m=sub_m)
        totals = {k: totals[k] + s[k] for k in totals}
    s = ops.sparse_matmul_tile_stats(h, sp["out_indices"],
                                     k_total=h.shape[-1], bk=chunk,
                                     sub_m=sub_m)
    totals = {k: totals[k] + s[k] for k in totals}

    # the fused in/gate launch shares one slot axis -> one schedule
    sub = SUB_M if sub_m is None else sub_m

    def occ_of(t):
        flat = t.reshape(-1, t.shape[-1])
        flat = F.pad(flat, (0, 0, 0, (-flat.shape[0]) % sub))
        return ops.activation_occupancy(flat, sub, chunk).bool()

    s_in = ops.schedule_stats(None, sp["in_indices"], bk=chunk,
                              occ=occ_of(xp),
                              gate_indices=sp.get("gate_indices"))
    s_out = ops.schedule_stats(None, sp["out_indices"], bk=chunk,
                               occ=occ_of(h))
    M = int(np.prod(x.shape[:-1]))
    pred = (ops._predicated_steps(M, *sp["in_indices"].shape, sub)
            + ops._predicated_steps(M, *sp["out_indices"].shape, sub))
    for key, src in (("scheduled_steps", "scheduled_steps"),
                     ("live_chunk_steps", "live_chunk_steps"),
                     ("flush_only_steps", "dead_pairs"),
                     ("dense_grid_steps", "dense_grid_steps")):
        totals[key] = (s_in[src] + s_out[src]).float()
    # a shape-only count: a number filled on the device, not a host tensor
    totals["predicated_grid_steps"] = torch.full(
        (), float(pred), dtype=torch.float32, device=x.device)
    return totals
