"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        [--smoke] [--steps N] [--seq S] [--batch B] [--ckpt DIR] \\
        [--microbatches M] [--lr LR] [--device cuda]

``--smoke`` takes the reduced config of the same family (runs on the CPU
with ``--device cpu``). A full config trains on one card where it fits:
Qwen3-4B's 4.02 B parameters take 12 bytes each in bf16 with their
gradients and AdamW's fp32 moments (~48 GB). ``--device`` defaults to
``cuda``; ``--mesh`` and ``--fsdp`` wait for the mesh port (A8).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, load_config, \
    load_smoke
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainLoopConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="data,model extents (needs the mesh port, A8)")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)
    if args.mesh or args.fsdp:
        raise NotImplementedError("--mesh and --fsdp need the mesh port "
                                  "(A8)")

    cfg = load_smoke(args.arch) if args.smoke else load_config(args.arch)
    shape = SHAPES[args.shape] if args.shape \
        else ShapeConfig("cli", args.seq, args.batch, "train")
    dev = torch.device(args.device)
    loop_cfg = TrainLoopConfig(
        steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    print(f"arch={cfg.name} device={dev} seq={shape.seq_len} "
          f"batch={shape.global_batch}")
    state = train(cfg, shape, loop_cfg, opt_cfg, device=dev)
    print(f"finished at step {state.step}")


if __name__ == "__main__":
    main()
