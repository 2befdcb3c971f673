"""Checkpointed training loop with restart (port of
``repro.train.loop``): the deterministic data pipeline, the train step,
atomic async checkpoints (one save in flight at a time) and resuming from
the newest complete checkpoint, on one device or sharded on a
``DeviceMesh`` (params and moments as ``DTensor`` leaves of
``dist.partitioning.param_shardings`` / ``adamw.opt_shardings``, every
batch placed by ``batch_spec``; a checkpoint restores onto any mesh). The
loop only sequences the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional


from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import batch_for
from repro_torch.dist import partitioning as part
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.train_step import GraphedTrainStep, make_train_step


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    microbatches: int = 1
    remat_group: int = 1
    fsdp: bool = False
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.OptState
    step: int


def shardings(cfg: ModelConfig, mesh, fsdp: bool = False):
    """(param shardings, optimizer shardings) of ``cfg`` on ``mesh``."""
    p_sh = part.param_shardings(mesh, M.abstract_params(cfg), fsdp=fsdp)
    return p_sh, adamw.opt_shardings(mesh, p_sh)


def init_state(cfg: ModelConfig, mesh=None, *, fsdp: bool = False,
               seed: int = 0, device="cuda") -> TrainState:
    """Fresh params from ``seed`` on ``device`` and a zero optimizer. On
    ``mesh`` every rank draws the same values as solo, then keeps its own
    slice of each leaf (``param_shardings``, FSDP with ``fsdp``)."""
    if fsdp and mesh is None:
        raise ValueError("fsdp shards over a mesh's data dim: give mesh=")
    params = M.init_params(cfg, seed=seed, device=device)
    if mesh is not None:
        params = part.distribute_tree(params, shardings(cfg, mesh,
                                                        fsdp)[0])
    return TrainState(params, adamw.init(params), 0)


def restore_or_init(cfg: ModelConfig, loop_cfg: TrainLoopConfig,
                    mesh=None, device="cuda") -> TrainState:
    """Resume from the newest complete checkpoint in ``loop_cfg.ckpt_dir``
    if there is one, else :func:`init_state`. A resume never draws a fresh
    init: the templates are ``abstract_params`` (meta tensors). On
    ``mesh`` each rank reads its own slices (``param_shardings`` /
    ``opt_shardings``), whatever mesh saved the checkpoint (the elastic
    restart)."""
    last = ckpt.latest_step(loop_cfg.ckpt_dir) if loop_cfg.ckpt_dir \
        else None
    if last is None:
        return init_state(cfg, mesh, fsdp=loop_cfg.fsdp, seed=loop_cfg.seed,
                          device=device)
    abs_p = M.abstract_params(cfg)
    p_sh = o_sh = None
    if mesh is not None:
        p_sh, o_sh = shardings(cfg, mesh, loop_cfg.fsdp)
    params, opt, man = ckpt.restore(loop_cfg.ckpt_dir, last, abs_p,
                                    adamw.init(abs_p), device=device,
                                    shardings=p_sh, opt_shardings=o_sh)
    return TrainState(params, opt, int(man["step"]))


def train(cfg: ModelConfig, shape: ShapeConfig,
          loop_cfg: TrainLoopConfig = TrainLoopConfig(),
          opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
          mesh=None,
          step_hook: Optional[Callable[[int, Dict], None]] = None,
          post_step: Optional[Callable] = None,
          device="cuda", compiled: bool = True) -> TrainState:
    """Run the loop from :func:`restore_or_init` to ``loop_cfg.steps``;
    returns the final state.

    ``step_hook(step, metrics)`` gets each step's metrics as floats and its
    seconds (``sec``, host clock up to the metrics' read); without one, a
    line is printed every ``log_every`` steps. ``post_step(state,
    metrics)`` may return a new state (re-applied pruning masks, a rotated
    MoE expert permutation). Every ``ckpt_every`` steps the state is saved
    asynchronously (its host copy taken before the next step), one save in
    flight at a time; the last is joined before returning. The params and
    moments are updated in place from step to step.

    ``compiled`` (the default, as the reference always jits its step)
    replays the step captured as one CUDA graph (:class:`~repro_torch.
    train.train_step.GraphedTrainStep`: the first step eager, then the
    capture; the state's tensors are its buffers, a resumed state's its
    own graph's); ``compiled=False`` runs the same donated step eagerly.
    On the CPU both run the step directly.

    ``mesh`` (a ``DeviceMesh`` this process is a rank of; ``device`` its
    own device): the state is sharded (``loop_cfg.fsdp`` adds FSDP) and
    every batch is placed by ``batch_spec``; the metrics are replicated,
    the checkpoints are gathered and written by the mesh's first rank.
    """
    state = restore_or_init(cfg, loop_cfg, mesh, device=device)
    place = None
    if mesh is not None:
        place = part.NamedSharding.of(mesh, part.batch_spec(mesh))
    # the state is donated: each step updates its params and moments in
    # place (as the reference jits its step with donate_argnums), so a
    # step holds one copy of them
    kw = dict(microbatches=loop_cfg.microbatches,
              remat_group=loop_cfg.remat_group)
    step_fn = GraphedTrainStep(cfg, opt_cfg, **kw) if compiled \
        else make_train_step(cfg, opt_cfg, donate=True, **kw)
    pending_save = None
    while state.step < loop_cfg.steps:
        batch = batch_for(cfg, shape, state.step, seed=loop_cfg.seed,
                          device=device)
        if place is not None:
            batch = {k: part.distribute(v, place) for k, v in batch.items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(state.params, state.opt, batch)
        # the metrics are the graph's outputs: read before the next replay
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        state = TrainState(params, opt, state.step + 1)
        if post_step is not None:
            state = post_step(state, metrics) or state
        if step_hook:
            step_hook(state.step, {**metrics, "sec": dt})
        elif state.step % loop_cfg.log_every == 0:
            print(f"step {state.step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics.get('grad_norm', 0):.2f} "
                  f"{dt * 1e3:.0f} ms")
        if (loop_cfg.ckpt_dir and loop_cfg.ckpt_every
                and state.step % loop_cfg.ckpt_every == 0):
            if pending_save is not None:
                pending_save.join()         # one save in flight at a time
            # save_async copies the state to the host before it returns,
            # so the next replay cannot overwrite what it saves
            pending_save = ckpt.save_async(
                loop_cfg.ckpt_dir, state.step, state.params, state.opt,
                extra={"arch": cfg.name, "loss": metrics["loss"]})
    if pending_save is not None:
        pending_save.join()
    return state
