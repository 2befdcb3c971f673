"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        [--smoke] [--steps N] [--seq S] [--batch B] [--ckpt DIR] \\
        [--microbatches M] [--lr LR] [--device cuda] [--eager] \\
        [--layers L] [--mesh D,M [--fsdp]]

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node N \\
        -m repro_torch.launch.train --arch qwen3_4b ... --mesh D,M --fsdp

``--smoke`` takes the reduced config of the same family (runs on the CPU
with ``--device cpu``). A full config trains on one card where it fits:
Qwen3-4B's 4.02 B parameters take 12 bytes each in bf16 with their
gradients and AdamW's fp32 moments (~48 GB). ``--device`` defaults to
``cuda``. ``--mesh D,M`` trains sharded on a (data=D, model=M)
``DeviceMesh``, one process per rank under ``torch.distributed.run`` (each
rank on ``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo; ``--mesh 1,1``
alone starts a one-rank world in-process), and ``--fsdp`` adds FSDP over
the data dim. The step is captured as one CUDA graph and replayed (the
reference jits it); ``--eager`` runs it op by op. ``--layers`` cuts the
depth. At the end it prints the median step time (host clock, the steps after the first two:
the eager warm-up with the capture, and the first replay) and, on the
card, the peak memory (the first rank prints); ``main`` returns them on
every rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ShapeConfig, load_config, \
    load_smoke
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainLoopConfig, train


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="train sharded on a (data, model) mesh of D*M "
                         "ranks (one process each, under "
                         "torch.distributed.run)")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --mesh: FSDP over the data dim")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    ap.add_argument("--eager", action="store_true",
                    help="run the step op by op, not its CUDA graph")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    if args.fsdp and not args.mesh:
        ap.error("--fsdp shards over a mesh: give --mesh D,M")

    cfg = load_smoke(args.arch) if args.smoke else load_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = SHAPES[args.shape] if args.shape \
        else ShapeConfig("cli", args.seq, args.batch, "train")
    dev = torch.device(args.device)
    mesh, started = None, False
    if args.mesh:
        from repro_torch.launch.mesh import make_debug_mesh
        data, model = (int(v) for v in args.mesh.split(","))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        started = not dist.is_initialized()
        mesh = make_debug_mesh(model, data, device=dev)
        if dist.get_world_size() != data * model:
            raise SystemExit(f"--mesh {args.mesh} needs a world of "
                             f"{data * model} ranks, got "
                             f"{dist.get_world_size()}")
    first = mesh is None or not any(mesh.get_coordinate())
    loop_cfg = TrainLoopConfig(
        steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches, fsdp=args.fsdp)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    if first:
        print(f"arch={cfg.name} layers={cfg.n_layers} device={dev} "
              f"seq={shape.seq_len} batch={shape.global_batch} "
              f"step={'eager' if args.eager else 'graph'}"
              + (f" mesh=(data={data}, model={model})"
                 f"{' fsdp' if args.fsdp else ''}" if mesh else ""))
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(dev)     # (train raises if not)
    secs = []

    def hook(step: int, m: Dict[str, float]) -> None:
        secs.append(m["sec"])
        if first and step % loop_cfg.log_every == 0:
            print(f"step {step:5d} loss {m['loss']:.4f} gnorm "
                  f"{m['grad_norm']:.2f} {m['sec'] * 1e3:.0f} ms")

    state = train(cfg, shape, loop_cfg, opt_cfg, mesh=mesh, device=dev,
                  compiled=not args.eager, step_hook=hook)
    out = {"steps": state.step, "layers": cfg.n_layers,
           "step_ms": float(np.median(secs[2:] or secs)) * 1e3,
           "first_ms": secs[0] * 1e3 if secs else float("nan"),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30
           if dev.type == "cuda" else float("nan")}
    if first:
        print(f"finished at step {state.step}: step {out['step_ms']:.3f} "
              f"ms (median, host clock, after the first two), the first "
              f"{out['first_ms']:.3f} ms, peak {out['peak_gib']:.3f} GiB")
    if started:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
