"""Vision launcher: batched sparse CNN inference through the engine.

    PYTHONPATH=src python -m repro_torch.launch.vision --bench VGGNet --smoke
    PYTHONPATH=src python -m repro_torch.launch.vision --bench VGGNet \\
        --image-size 224 --pattern chunk --requests 8 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.vision --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.vision --smoke --pattern \
        chunk --autotune --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.vision --smoke --device cpu \
        --mesh 2
    PYTHONPATH=src python -m repro_torch.launch.vision --mesh 1

Builds a pruned network for one of the Table-1 benchmarks, checks the first
image against the dense oracle through the instrumented dense-grid kernel,
prints per-layer measured densities and skipped-tile fractions, and serves
staggered image requests through the round-robin engine (the work-list
walker). ``--autotune`` tunes every layer's tile config first (the
deterministic cost model of :mod:`repro_torch.kernels.autotune`) and the
engine runs the tuned configs. ``--device`` defaults to ``cuda``;
wall-clock numbers from any other device are not the card's. ``--mesh N``
data-shards the engine's slot batch over an N-rank ``("data",)`` mesh (N
divides ``--slots``; bitwise the unsharded engine's outputs): one process a
rank under ``torch.distributed.run`` (each on ``cuda:<local rank>`` over
NCCL, or on the CPU over gloo), or ``--mesh 1`` in one process; every rank
prints, and the packing balances each layer over N clusters
(``mesh_devices``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.core import simulator as S
from repro_torch.kernels.autotune import autotune_model
from repro_torch.vision import (ImageRequest, VisionEngine,
                                build_vision_model, layer_table,
                                measured_densities, oracle_check)


def blob_images(rng: np.random.Generator, n: int, size: int,
                live_frac: float) -> np.ndarray:
    """Synthetic feature-map-sparse inputs: non-negative blobs on a zero
    background, ~``live_frac`` of the pixels live."""
    if not 0.0 <= live_frac <= 1.0:
        raise ValueError(f"live_frac must be in [0, 1], got {live_frac}")
    imgs = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        area = 0.0
        # bounded: near-1 targets stop at the cap instead of chasing the
        # last uncovered pixels
        for _ in range(64 * max(size, 1)):
            if area >= live_frac:
                break
            h = rng.integers(1, max(size // 2, 2))
            w = rng.integers(1, max(size // 2, 2))
            r, c = rng.integers(0, size - h + 1), rng.integers(0, size - w + 1)
            imgs[i, r:r + h, c:c + w] = np.abs(
                rng.normal(size=(h, w, 3))).astype(np.float32)
            area = (imgs[i] != 0).mean()
    return imgs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="VGGNet",
                    choices=["AlexNet", "VGGNet", "ResNet18", "ResNet50"])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny 2-layer net at 16 px")
    ap.add_argument("--layers", type=int, default=None,
                    help="truncate the network to N layers")
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--density", type=float, default=None,
                    help="filter density (default: paper Table 1)")
    ap.add_argument("--pattern", default="unstructured",
                    choices=["unstructured", "chunk"],
                    help="pruning pattern: chunk = tile-aligned structured "
                         "pruning (real dead chunks for the schedule)")
    ap.add_argument("--autotune", action="store_true",
                    help="per-layer tile autotuning (deterministic cost "
                         "model); the engine runs the tuned configs")
    ap.add_argument("--map-density", type=float, default=None,
                    help="input live-pixel fraction (default: Table 1)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--stagger", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the network runs on (default cuda)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="data-shard the engine batch over an N-rank mesh "
                         "(N must divide --slots; bitwise identical to "
                         "solo); N > 1 runs under torch.distributed.run")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    mesh = None
    if args.mesh is not None:
        from repro_torch.vision.mesh import data_mesh
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        mesh = data_mesh(args.mesh, device=device)
    layers = 2 if args.smoke and args.layers is None else args.layers
    size = args.image_size if args.image_size is not None else \
        (16 if args.smoke else 32)
    model = build_vision_model(args.bench, density=args.density,
                               num_layers=layers, seed=args.seed,
                               pattern=args.pattern, mesh_devices=args.mesh,
                               device=device)
    if args.autotune:
        for i, r in autotune_model(model, size).items():
            c = r.config
            print(f"autotune layer {i}: bm={c.bm_rows} bn={c.bn} "
                  f"sub_m={c.sub_m} im2col={c.im2col}")
    md = args.map_density if args.map_density is not None else \
        S.BENCHMARKS[args.bench].map_density
    rng = np.random.default_rng(args.seed)
    imgs = blob_images(rng, args.requests, size, md)

    # correctness: first image, sparse kernel path vs dense oracle
    x0 = torch.as_tensor(imgs[:1], device=device)
    out0, stats, rel = oracle_check(model, x0)
    print(f"{args.bench}: {model.num_layers} layers @ {size}px on {device}, "
          f"filter density {model.density}")
    print(f"sparse conv path vs dense oracle: rel err {rel:.2e}")
    if not rel <= 1e-5:
        raise SystemExit("sparse conv path diverged from the dense oracle")

    for row in layer_table(stats):
        print(row)
    fd, md_meas = measured_densities(stats)
    print(f"measured network densities: filters {fd:.3f}, maps {md_meas:.3f}")

    eng = VisionEngine(model, num_slots=args.slots,
                       use_tuned=args.autotune, mesh=mesh)
    reqs = [ImageRequest(rid=i, image=imgs[i], arrival=i * args.stagger)
            for i in range(args.requests)]
    produced = eng.run(reqs)
    st = eng.stats
    print(f"engine: {st.images} images on {args.slots} slots in "
          f"{st.engine_steps} steps, {st.wall_s:.3f}s "
          f"({st.img_per_s:.2f} img/s steady, first-call set-up "
          f"{st.compile_s:.2f}s, util {st.slot_utilization:.2f}, "
          f"device {device})")
    if mesh is not None:
        sc = eng.schedule_counters()
        print(f"mesh: {sc['num_devices']} devices, per-device steps "
              f"{sc['per_device_steps']}, imbalance "
              f"{sc['step_imbalance']:.3f}, scaling efficiency "
              f"{sc['step_scaling_efficiency']:.3f}")
    if not np.allclose(produced[0], out0[0].cpu().numpy(), atol=1e-5):
        raise SystemExit("engine output must match the solo forward")
    print("engine output matches solo forward")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
