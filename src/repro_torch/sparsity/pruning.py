"""Deep-Compression-style magnitude pruning of LM parameters (port of
``repro.sparsity.pruning``): prune the FFN and expert weights to a target
density, fine-tune with the mask fixed (the paper's retraining step), then
hand the pruned weights to ``sparse_ffn.sparsify_model`` for the BARISTA
kernels.

The mask is per output channel (each "filter" keeps its own top
magnitudes), as the paper's pruning, so the cross-filter density spread
that drives the load-imbalance story is realistic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import STACKS
from repro_torch.core.sparse import prune_by_magnitude
from repro_torch.train.train_step import GraphedTrainStep
from repro_torch.tree import map_tree, map_tree_with_path, path_key

Params = Dict[str, Any]

# FFN/expert weight leaf names eligible for the BARISTA sparse path
PRUNABLE = ("w_in", "w_gate", "w_out")


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    density: float = 0.35          # paper Table 1 filter densities ~0.33-0.57
    names: Sequence[str] = PRUNABLE
    min_size: int = 1024           # skip tiny leaves (norms, smoke configs)


def _is_prunable(path: Tuple, leaf: torch.Tensor, periods: int,
                 cfg: PruneConfig) -> bool:
    """The reference's test on its leaf stacked over ``periods``: the port
    holds one leaf per period, so ``min_size`` is held against ``periods``
    times the leaf's size (else the two packages prune different
    leaves)."""
    return (str(path[-1]) in cfg.names and leaf.ndim >= 2
            and periods * leaf.numel() >= cfg.min_size
            and leaf.is_floating_point())


def prune_masks(params: Params, cfg: PruneConfig = PruneConfig()) -> Params:
    """Binary fp32 masks on each leaf's device, the params' tree with
    ``None`` at leaves that are not pruned. A 3-D expert bank [E, in, out]
    is pruned slice by slice."""
    def mask_of(path, leaf):
        periods = len(params[path[0]]) if path[0] in STACKS else 1
        if not _is_prunable(path, leaf, periods, cfg):
            return None
        w = leaf.detach().float().cpu().numpy()
        flat = w.reshape(-1, w.shape[-2], w.shape[-1])
        m = np.stack([prune_by_magnitude(s, cfg.density, axis_out=-1)
                      for s in flat]).reshape(w.shape)
        return torch.as_tensor(m, device=leaf.device)

    return map_tree_with_path(mask_of, params)


def apply_masks(params: Params, masks: Params) -> Params:
    """Elementwise ``w * mask``; ``None`` masks pass the leaf through."""
    return map_tree(lambda p, m: p if m is None else p * m.to(p.dtype),
                    params, masks)


def mask_gradients(grads: Params, masks: Params) -> Params:
    """Zero the gradients at pruned positions (fixed-mask fine-tuning)."""
    return map_tree(lambda g, m: g if m is None or g is None
                    else g * m.to(g.dtype), grads, masks)


def density_report(params: Params, masks: Params) -> Dict[str, float]:
    """{leaf path: realised density} of every pruned leaf."""
    out: Dict[str, float] = {}
    map_tree_with_path(lambda path, p, m: None if m is None else
                       out.__setitem__(path_key(path), float(m.mean())),
                       params, masks)
    return out


def make_pruned_train_step(base_step: Callable, masks: Params) -> Callable:
    """Wrap a train step so the params leave every step pruned. Masking
    after the optimizer update (rather than masking the gradients alone)
    also cancels weight decay's and momentum's drift at pruned
    positions.

    A captured step (``train_step.GraphedTrainStep``) gives its captured
    form: the masks multiplied into the params in place inside the graph,
    after AdamW (the bits of :func:`apply_masks`), so the params stay the
    graph's buffers from step to step and are never copied in. Any other
    step is wrapped eagerly (new params each step)."""
    if isinstance(base_step, GraphedTrainStep):
        return base_step.with_masks(masks)

    def step(params, opt_state, batch):
        new_params, new_opt, metrics = base_step(params, opt_state, batch)
        return apply_masks(new_params, masks), new_opt, metrics
    return step
