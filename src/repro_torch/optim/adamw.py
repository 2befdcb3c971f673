"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule (port of ``repro.optim.adamw``). Moments live in
fp32 beside each param; the update is cast back to the param's dtype;
integer leaves (``expert_perm``) pass through. Written out as the reference
writes it, not ``torch.optim.AdamW``, whose bias correction and eps sit
elsewhere.

On a mesh the params are ``DTensor`` leaves: the moments take each
param's placements, the step counter is replicated (:func:`opt_shardings`),
and :func:`apply` first reduces each gradient to its param's placements
(a data-parallel gradient arrives as a partial sum, and the moments are
not linear in it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.dist.partitioning import replicate, replicated
from repro_torch.tree import flatten_tree, map_tree, map_tree_with_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # int32, 0-d, on the params' device
    mu: Any                 # fp32 tree shaped as the params
    nu: Any


def zeros_like(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros shaped as ``p`` (a DTensor's with its placements)."""
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params) -> OptState:
    """Zero moments (fp32, every leaf, the integer ones too) and step 0
    (DTensor params: moments of their placements, a replicated step)."""
    first = next(iter(flatten_tree(params).values()))
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):
        mesh = first.device_mesh
        step = DTensor.from_local(
            torch.zeros((), dtype=torch.int32,
                        device=first.to_local().device),
            mesh, (Replicate(),) * mesh.ndim, run_check=False)
    return OptState(step, map_tree(zeros_like, params), map_tree(zeros_like, params))


def opt_shardings(mesh, param_shardings) -> OptState:
    """The OptState's shardings on ``mesh``: the moments are elementwise,
    so they take the params' (``dist.partitioning.param_shardings``); the
    step counter is replicated."""
    return OptState(replicated(mesh), param_shardings, param_shardings)


def reduce_grads(params, grads):
    """Each DTensor gradient redistributed to its param's placements (a
    partial sum over the data dims is all-reduced, a shard moved);
    plain and ``None`` leaves as they are."""
    def one(p, g):
        if not isinstance(g, DTensor) or tuple(g.placements) == \
                tuple(p.placements):
            return g
        return g.redistribute(p.device_mesh, p.placements)
    return map_tree(one, params, grads)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps`` (fp32, 0-d)."""
    s = torch.as_tensor(step).float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clip((s - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every floating leaf, in fp32; ``None``
    leaves (an integer param's missing gradient) are skipped. DTensor
    leaves sum to one replicated scalar."""
    sq = []
    # a DTensor leaf's sum over its shard is partial: reduced to every rank
    map_tree(lambda g: sq.append(replicate(torch.sum(torch.square(
        g.float()))))
             if g is not None and g.is_floating_point() else None, tree)
    return torch.sqrt(sum(sq))


def _decayable(path) -> bool:
    name = str(path[-1])
    return name not in ("ln1", "ln2", "ln_cross", "ln_x", "final_norm",
                        "enc_norm", "q_norm", "k_norm", "dt_bias", "D",
                        "u_bonus", "expert_perm") and "mu_" not in name


def apply(cfg: AdamWConfig, params, grads, state: OptState, *,
          donate: bool = False):
    """One AdamW step -> (new_params, new_state, metrics ``grad_norm`` and
    ``lr``). ``grads`` is shaped as the params, ``None`` at integer
    leaves. Nothing given is modified, unless ``donate``: then each new
    param and moment is written into the tensor it replaces, leaf by leaf
    (the same bits), so the step holds one copy of the params and moments
    instead of two (the counterpart of the reference loop's
    ``donate_argnums``), and the step counter is advanced in place; the
    given trees are then the results. ``lr`` and the bias corrections stay
    device tensors computed from the counter, so a captured step (a CUDA
    graph replayed on the same buffers) reads each step's own values.

    DTensor params: each gradient is first brought to its param's
    placements (:func:`reduce_grads`); the in-place updates keep every
    leaf's placements."""
    grads = reduce_grads(params, grads)
    gnorm = global_norm(grads)
    scale = torch.ones_like(gnorm)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step.add_(1) if donate else state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(path, p, g, mu, nu):
        if not p.is_floating_point():
            return p, mu, nu
        g = g.float() * scale
        new_mu = cfg.b1 * mu + (1 - cfg.b1) * g
        new_nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        u = (new_mu / b1c) / (torch.sqrt(new_nu / b2c) + cfg.eps)
        if cfg.weight_decay and _decayable(path):
            u = u + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * u).to(p.dtype)
        if not donate:
            return new_p, new_mu, new_nu
        p.copy_(new_p)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        return p, mu, nu

    flat = map_tree_with_path(upd, params, grads, state.mu, state.nu)
    return _unzip(flat, 0), OptState(step, _unzip(flat, 1),
                                     _unzip(flat, 2)), \
        {"grad_norm": gnorm, "lr": lr}


def _unzip(tree, i: int):
    """Element ``i`` of every (param, mu, nu) triple of ``apply``."""
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unzip(v, i) for v in tree]
    return tree[i]
