"""The training step (port of ``repro.train.train_step``): the loss
(cross entropy with a z-loss and the MoE aux loss), gradients, microbatch
accumulation and activation checkpointing, then one AdamW step.

``make_train_step(cfg, opt_cfg, microbatches)`` returns ``step(params,
opt_state, batch) -> (params, opt_state, metrics)``, which leaves what it
is given unchanged unless asked to update it in place (``donate``).
:class:`GraphedTrainStep` is that donated step captured as one CUDA graph
(forward, remat's recompute, the gradients and the AdamW update), the
counterpart of the reference's ``jax.jit(step, donate_argnums=(0, 1))``.
Nothing in either launches a kernel of this package: the reference trains
the dense forward too.

On a mesh the params (and the optimizer state) are ``DTensor`` leaves of
``dist.partitioning.param_shardings`` and the batch is placed by
``batch_spec``: the same step then runs sharded, DTensor propagating the
placements through every op (:func:`loss_and_grads` runs under
``implicit_replication``, so the plain tensors the forward builds, its
positions, masks and RoPE tables, count as replicated).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.overrides import TorchFunctionMode

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.partitioning import local_slices, replicate
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import flatten_tree, map_tree

MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over tokens, mean z-loss ``logsumexp**2``), in fp32.
    Vocab-sharded ``DTensor`` logits (a sharded head) are gathered over
    the vocab first: the loss takes whole rows."""
    logits = _whole_rows(logits.float())
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - _gold(logits, labels)), torch.mean(lse * lse)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The logit of each label, ``logits [..., V]`` at ``labels [...]``.
    DTensor logits (whole rows) on each rank's rows: DTensor's gather
    backward allocates the gradient at the global shape on every rank
    (``new_zeros``), the whole batch's logits."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    mesh, place = logits.device_mesh, tuple(logits.placements)
    lab = labels if isinstance(labels, DTensor) else DTensor.from_local(
        labels, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    if tuple(lab.placements) != place:
        lab = lab.redistribute(mesh, place)
    gold = torch.gather(logits.to_local(), -1,
                        lab.to_local().long()[..., None])[..., 0]
    return DTensor.from_local(gold, mesh, place, run_check=False)


def _whole_rows(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its last dim whole on every rank: shards of the last
    dim gathered and partial sums reduced (shards of other dims kept); a
    plain tensor unchanged."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    want = tuple(pl if isinstance(pl, Shard) and pl.dim % x.ndim != last
                 else Replicate() for pl in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


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


# the context a step on DTensor params runs in (``implicit_replication``,
# not nested)
sharded = M.sharded


def loss_and_grads(params, batch, cfg: ModelConfig, **loss_kw):
    """(loss, {"ce", "moe_aux"}, grads) of :func:`loss_fn`: the gradient of
    every floating leaf (``torch.autograd.grad``; the params are not
    modified), ``None`` at integer leaves (``expert_perm``). DTensor params
    give a replicated loss and aux and DTensor gradients in whatever
    placements the backward left them (partial sums over the data dims;
    ``adamw.reduce_grads`` brings them to the params')."""
    live = map_tree(lambda p: p.detach().requires_grad_(True)
                    if p.is_floating_point() else p, params)
    leaves = [p for p in flatten_tree(live).values() if p.requires_grad]
    with torch.enable_grad(), sharded(params):
        loss, aux = loss_fn(live, batch, cfg, **loss_kw)
        loss = replicate(loss)
        grads = iter(torch.autograd.grad(loss, leaves))
    grads = map_tree(lambda p: next(grads) if p.requires_grad else None,
                     live)
    return loss.detach(), {k: replicate(v.detach()) for k, v in aux.items()}, \
        grads


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
            # gradient accumulation, one microbatch after another: each
            # microbatch's gradients land in fp32 buffers (the reference's
            # BARISTA "colored output buffer"), in the params' placements
            grads = map_tree(lambda p: adamw.zeros_like(p)
                             if p.is_floating_point() else None, params)
            loss = 0.0
            for i in range(microbatches):
                mb = {k: microbatch(v, i, microbatches)
                      for k, v in batch.items()}
                l_i, _, g_i = loss_and_grads(params, mb, cfg, **loss_kw)
                g_i = adamw.reduce_grads(params, g_i)
                grads = map_tree(lambda a, g: None if g is None
                                 else a + g.float() / microbatches,
                                 grads, g_i)
                loss = loss + l_i / microbatches
            # as the reference: "ce" is the total loss and "moe_aux" 0
            # when accumulating
            aux_m = {"ce": loss, "moe_aux": torch.zeros_like(loss)}
        new_params, new_opt, om = adamw.apply(opt_cfg, params, grads,
                                              opt_state, donate=donate)
        return new_params, new_opt, {"loss": loss, **aux_m, **om}

    return step


def microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a batch tensor: its rows ``[i * b / n,
    (i + 1) * b / n)``. A batch DTensor gives the same rows as solo (a MoE's
    capacity depends on which tokens share a microbatch), placed as the
    batch is: the (small, integer) batch is gathered and each rank keeps
    its share of the microbatch's rows. Where the microbatch's rows do not
    divide over every dim that splits the batch (a multi-pod mesh's 32
    data ranks, a 16-row microbatch), the dims past the longest prefix
    that divides them hold its rows whole."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    if isinstance(x, DTensor):
        rows = microbatch(x.full_tensor(), i, n)
        mesh, place = x.device_mesh, list(x.placements)
        k = 1
        for d, pl in enumerate(place):
            if isinstance(pl, Shard) and pl.dim == 0:
                k *= mesh.size(d)
                if rows.shape[0] % k:
                    place[d] = Replicate()
        place = tuple(place)
        return DTensor.from_local(
            rows[local_slices(mesh, place, rows.shape)].contiguous(), mesh,
            place, run_check=False)
    return x.reshape(n, b // n, *x.shape[1:])[i]


def _mask_in_place(params, masks) -> None:
    """``p *= mask`` at every masked leaf: the bits of
    ``pruning.apply_masks`` written into the params."""
    map_tree(lambda p, m: None if m is None else p.mul_(m.to(p.dtype)),
             params, masks)


@graphs.captured
def _train_body(step, masks):
    """The captured train step: (params, opt_state, batch) -> (params,
    opt_state, metrics), the donated ``step`` (params, moments and the
    counter updated in place), then the fixed masks multiplied into the
    params in place."""
    def body(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        if masks is not None:
            _mask_in_place(params, masks)
        return params, opt_state, metrics
    return body


class GraphedTrainStep:
    """The train step captured in one CUDA graph: the port's counterpart of
    the reference's ``jax.jit(step, donate_argnums=(0, 1))``. Called as
    :func:`make_train_step`'s step is: (params, opt_state, batch) ->
    (params, opt_state, metrics), with the same arguments
    (``microbatches`` fixed per object).

    * **Buffers.** The params and the optimizer state are adopted at the
      first call as the graph's buffers, updated in place by every replay
      (``donate``), and returned; the batch is copied into a static
      buffer. A call given other tensors of the same geometry (a restored
      state) copies them in. The metrics (``loss``, ``ce``, ``moe_aux``,
      ``grad_norm``, ``lr``) are the graph's 0-d outputs: read them before
      the next call.
    * **Warm-up.** The first call runs the step eagerly (it is the real
      step: params and moments advance once) and the capture follows.
    * **Graphs.** One per batch geometry (the keys, shapes and types of the
      batch), each holding the device memory of one step's intermediates
      in its pool for as long as this object lives.
    * ``masks`` (the params' tree, ``None`` at unpruned leaves): fixed-mask
      fine-tuning, each masked param multiplied by its mask in place after
      AdamW, bitwise ``pruning.apply_masks`` of the step's params
      (:func:`with_masks`).

    On the CPU the body runs directly: the donated step.
    """

    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                 microbatches: int = 1, remat_group: int = 1,
                 ssm_chunk=None, flash_chunk=None, masks=None):
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.kw = dict(microbatches=microbatches, remat_group=remat_group,
                       ssm_chunk=ssm_chunk, flash_chunk=flash_chunk)
        self.masks = masks
        self.graphs: dict = {}

    def with_masks(self, masks) -> "GraphedTrainStep":
        """A new step of the same arguments with ``masks`` fixed."""
        return GraphedTrainStep(self.cfg, self.opt_cfg, masks=masks,
                                **self.kw)

    def graph_for(self, params, batch) -> graphs.CapturedGraph:
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())
        g = self.graphs.get(key)
        if g is None:
            step = make_train_step(self.cfg, self.opt_cfg, donate=True,
                                   **self.kw)
            g = graphs.CapturedGraph(
                _train_body(step, self.masks), params["embed"].device,
                f"{self.cfg.name} train step (batch "
                f"{tuple(batch['tokens'].shape)})", adopt=(0, 1),
                keep=self.masks)
            self.graphs[key] = g
        return g

    def __call__(self, params, opt_state: adamw.OptState, batch):
        return self.graph_for(params, batch)(params, opt_state, batch)


def make_eval_step(cfg: ModelConfig):
    """``step(params, batch) -> {"loss", "ce", "moe_aux"}`` without
    gradients or remat."""
    def step(params, batch):
        with torch.no_grad(), sharded(params):
            loss, aux = loss_fn(params, batch, cfg, remat=False)
        return {k: replicate(v) for k, v in {"loss": loss, **aux}.items()}
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
