"""End-to-end training example on the PyTorch port: pruned ("sparse-filter")
LM training with fault-tolerant checkpointing.

    PYTHONPATH=src python examples/torch_train_sparse_lm.py \\
        [--steps 300] [--d-model 256] [--layers 8] [--ckpt DIR] [--device cpu]

Trains a GPT-style LM (defaults ~10M params) on the deterministic synthetic
pipeline with:
  * Deep-Compression-style pruning masks re-applied after every step (the
    BARISTA filter-sparsity regime: pruned weights stay exactly zero),
  * asynchronous checkpoints every ``--ckpt-every`` steps into ``--ckpt``
    and resume from the newest one (kill it mid-run and start it again
    with the same ``--ckpt``: it continues from the last commit),
  * a loss that decreases (the synthetic stream has learnable bigram
    structure).

On the card the step is captured and replayed as one CUDA graph; the masks
are multiplied into its params in place between replays. ``--device``
defaults to ``cuda``; ``main(argv)`` returns the losses and the sparsity
check.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.sparsity import pruning
from repro_torch.train.loop import TrainLoopConfig, train
from repro_torch.tree import flatten_tree, map_tree


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--density", type=float, default=0.35)
    ap.add_argument("--ckpt", default="build/sparse_lm_ckpt",
                    help="checkpoint directory (resumed from when it holds "
                         "one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = ModelConfig(
        name=f"sparse-lm-{args.d_model}d{args.layers}L", family="dense",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 128, 1), d_head=64,
        d_ff=4 * args.d_model, vocab=4096, act="relu2", dtype="float32",
        sparse_ffn=True)

    # pruning masks fixed at init (prune-then-retrain, the paper's regime):
    # the loop draws the same init from its seed
    params0 = M.init_params(cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in flatten_tree(params0).values())
    print(f"model {cfg.name}: ~{n_params / 1e6:.1f}M params, "
          f"FFN density target {args.density:.0%}, on {device}")
    masks = pruning.prune_masks(
        params0, pruning.PruneConfig(density=args.density))
    realized = pruning.density_report(params0, masks)
    del params0
    print(f"pruned {len(realized)} weight tensors, e.g. "
          f"{list(realized.items())[:2]}")

    shape = ShapeConfig("lm", args.seq, args.batch, "train")
    loop_cfg = TrainLoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt, log_every=20)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps)
    losses: List[float] = []

    @torch.no_grad()
    def post_step(state, metrics):
        # re-apply the masks after the optimizer step, in place (the
        # captured step's params are its graph's buffers): pruned weights
        # stay 0
        map_tree(lambda p, m: None if m is None else p.mul_(m.to(p.dtype)),
                 state.params, masks)
        losses.append(metrics["loss"])
        return state

    state = train(cfg, shape, loop_cfg, opt_cfg, post_step=post_step,
                  device=device)

    # the sparsity contract survived training
    flat_p = flatten_tree(state.params)
    kept = 0
    for key, mk in flatten_tree(masks).items():
        if mk is None:
            continue
        if bool((flat_p[key][mk == 0] != 0).any()):
            raise RuntimeError(f"{key}: a pruned weight is non-zero")
        kept += 1
    print(f"sparsity contract held for {kept} tensors after "
          f"{state.step} steps")
    return {"losses": losses, "steps": state.step, "masked": kept,
            "params": n_params}


if __name__ == "__main__":
    main()
