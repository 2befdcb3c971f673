"""The training step (port of ``repro.train.train_step``): the loss
(cross entropy with a z-loss and the MoE aux loss), gradients, microbatch
accumulation and activation checkpointing, then one AdamW step.

``make_train_step(cfg, opt_cfg, microbatches)`` returns ``step(params,
opt_state, batch) -> (params, opt_state, metrics)``, which leaves what it
is given unchanged unless asked to update it in place (``donate``). The
step runs eagerly; capturing it as one CUDA graph
(the counterpart of the reference's ``jax.jit`` with donation) is ROADMAP
A7b. Nothing in it launches a kernel of this package: the reference trains
the dense forward too.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw

MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over tokens, mean z-loss ``logsumexp**2``), in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold), torch.mean(lse * lse)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True, remat_group: int = 1, ssm_chunk=None,
            flash_chunk=None):
    """-> (CE + MOE_AUX_WEIGHT * aux + Z_LOSS_WEIGHT * z, {"ce", "moe_aux"})
    of ``batch`` (``tokens``, ``labels`` and the frontend's embeddings)."""
    extras = {k: batch[k] for k in ("prefix_embeds", "src_embeds")
              if k in batch}
    logits, aux = M.forward(params, batch["tokens"], cfg, remat=remat,
                            remat_group=remat_group, ssm_chunk=ssm_chunk,
                            flash_chunk=flash_chunk, **extras)
    ce, z = cross_entropy(logits, batch["labels"])
    loss = ce + MOE_AUX_WEIGHT * aux + Z_LOSS_WEIGHT * z
    return loss, {"ce": ce, "moe_aux": aux}


def loss_and_grads(params, batch, cfg: ModelConfig, **loss_kw):
    """(loss, {"ce", "moe_aux"}, grads) of :func:`loss_fn`: the gradient of
    every floating leaf (``torch.autograd.grad``; the params are not
    modified), ``None`` at integer leaves (``expert_perm``)."""
    live = M.map_tree(lambda p: p.detach().requires_grad_(True)
                      if p.is_floating_point() else p, params)
    leaves = [p for p in M.flatten_tree(live).values() if p.requires_grad]
    with torch.enable_grad():
        loss, aux = loss_fn(live, batch, cfg, **loss_kw)
        grads = iter(torch.autograd.grad(loss, leaves))
    grads = M.map_tree(lambda p: next(grads) if p.requires_grad else None,
                       live)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, remat_group: int = 1,
                    ssm_chunk=None, flash_chunk=None, donate: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with remat on (one checkpoint per ``remat_group`` periods) and, for
    ``microbatches > 1``, the batch split along its first axis and the
    gradients accumulated in fp32 (metrics ``loss``, ``ce``, ``moe_aux``,
    ``grad_norm``, ``lr``; 0-d tensors on the device). ``donate``: the
    step updates the params and moments it is given in place
    (``adamw.apply(donate=True)``), as the reference's loop donates them
    to its jitted step."""
    loss_kw = dict(remat=True, remat_group=remat_group, ssm_chunk=ssm_chunk,
                   flash_chunk=flash_chunk)

    def step(params, opt_state: adamw.OptState, batch):
        if microbatches == 1:
            loss, aux_m, grads = loss_and_grads(params, batch, cfg,
                                                **loss_kw)
        else:
            def split(x, i):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])[i]

            # gradient accumulation, one microbatch after another: each
            # microbatch's gradients land in fp32 buffers (the reference's
            # BARISTA "colored output buffer")
            grads = M.map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)
                if p.is_floating_point() else None, params)
            loss = 0.0
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                l_i, _, g_i = loss_and_grads(params, mb, cfg, **loss_kw)
                grads = M.map_tree(lambda a, g: None if g is None
                                   else a + g.float() / microbatches,
                                   grads, g_i)
                loss = loss + l_i / microbatches
            # as the reference: "ce" is the total loss and "moe_aux" 0
            # when accumulating
            aux_m = {"ce": loss, "moe_aux": torch.zeros(
                (), dtype=torch.float32, device=loss.device)}
        new_params, new_opt, om = adamw.apply(opt_cfg, params, grads,
                                              opt_state, donate=donate)
        return new_params, new_opt, {"loss": loss, **aux_m, **om}

    return step


def make_eval_step(cfg: ModelConfig):
    """``step(params, batch) -> {"loss", "ce", "moe_aux"}`` without
    gradients or remat."""
    def step(params, batch):
        with torch.no_grad():
            loss, aux = loss_fn(params, batch, cfg, remat=False)
        return {"loss": loss, **aux}
    return step


class _Fp64(TorchFunctionMode):
    """Inside, every request for fp32 is one for fp64: ``Tensor.float``,
    ``.to(torch.float32)`` and ``dtype=torch.float32``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        args = tuple(torch.float64 if a is torch.float32 else a
                     for a in args)
        kwargs = {k: torch.float64 if v is torch.float32 else v
                  for k, v in (kwargs or {}).items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def promote_fp64():
    """The fp64 reference of fp32 work: inside, the casts to fp32 that the
    model, the loss and the optimizer make (norms, scores, logits, moments)
    ask for fp64 instead, so a step run on fp64 params is fp64 throughout.
    Holds a step's fp32 numerics on a device to fp64 on the same one. The
    backward's recompute runs outside the mode, so take the fp64 step as
    ``loss_and_grads(..., remat=False)`` then ``adamw.apply`` (remat
    changes no bit, see the tests)."""
    with _Fp64():
        yield
