"""The paper's own experiment on the PyTorch port: sparse CNN inference,
then that network's row of Figure 7 at the densities it measured.

    PYTHONPATH=src python examples/torch_sparse_cnn_sim.py [--bench VGGNet]
        [--image-size 40] [--layers N] [--pattern chunk] [--device cpu]

Runs the whole pruned network (paper Table-1 filter density) through the
instrumented sparse conv (``oracle_check``: the dense-grid kernel on the
card, its plain version on the CPU), checks it against the dense oracle,
prints the measured per-layer densities against Table 1, then feeds the
network's measured densities to the cycle model
(:mod:`repro_torch.core.simulator`) for this benchmark's row of Figure 7:
each scheme's speedup over Dense with its barrier and bandwidth shares.
``--device`` defaults to ``cuda``.

``main(argv)`` returns the row, the measured densities, the rel err, the
per-layer stats and the model, so callers drive it in-process.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import simulator as S
from repro_torch.launch.vision import blob_images
from repro_torch.vision import (SUPPORTED_ARCHS, build_vision_model,
                                layer_table, measured_densities,
                                oracle_check)

ROW_SCHEMES = ("One-sided", "SCNN", "SparTen", "SparTen-Iso", "Synchronous",
               "BARISTA", "Ideal")


def figure7_row(bench: str, num_layers: int, fd: float, md: float
                ) -> Dict[str, Dict[str, float]]:
    """``bench``'s Figure-7 row over its first ``num_layers`` layers at
    filter / map densities ``fd`` / ``md``: per scheme its ``speedup`` over
    Dense and its ``barrier`` and ``bandwidth`` shares of its cycles."""
    meas = S.Benchmark(bench, S.BENCHMARKS[bench].layers[:num_layers], fd,
                       md)
    dense = S.simulate(meas, "Dense").cycles
    row = {}
    for s in ROW_SCHEMES:
        r = S.simulate(meas, s)
        row[s] = {"speedup": dense / r.cycles,
                  "barrier": r.barrier / max(r.cycles, 1e-9),
                  "bandwidth": r.bandwidth / max(r.cycles, 1e-9)}
    return row


def row_lines(bench: str, row: Dict[str, Dict[str, float]]) -> List[str]:
    """The row as printed lines."""
    return [f"Figure 7 row ({bench}, measured densities, 32K MACs):"] + [
        f"  {s:12s} {r['speedup']:5.2f}x over Dense (barrier "
        f"{r['barrier']:5.1%}, bandwidth {r['bandwidth']:5.1%})"
        for s, r in row.items()]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="VGGNet", choices=SUPPORTED_ARCHS)
    ap.add_argument("--image-size", type=int, default=40)
    ap.add_argument("--layers", type=int, default=None,
                    help="truncate the network (default: all layers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pattern", default="unstructured",
                    choices=["unstructured", "chunk"],
                    help="pruning pattern (chunk: tile-aligned)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the network runs on (default cuda)")
    args = ap.parse_args(argv)
    bench = S.BENCHMARKS[args.bench]

    # the real compute path: the whole pruned network
    model = build_vision_model(args.bench, num_layers=args.layers,
                               seed=args.seed, pattern=args.pattern,
                               device=args.device)
    print(f"{args.bench}: {model.num_layers} conv layers @ "
          f"{args.image_size}px, Table-1 filter density {model.density}, "
          f"{args.pattern} pattern, on {model.device}")
    rng = np.random.default_rng(args.seed)
    x = torch.as_tensor(blob_images(rng, 1, args.image_size,
                                    bench.map_density), device=model.device)
    out, stats, rel = oracle_check(model, x)
    print(f"two-sided sparse conv net vs dense oracle: rel err {rel:.2e}")

    # measured per-layer densities against paper Table 1
    for line in layer_table(stats, with_paper=True):
        print(line)
    fd, md = measured_densities(stats)
    print(f"measured network densities: filters {fd:.3f} (paper "
          f"{bench.filter_density}), maps {md:.3f} (paper "
          f"{bench.map_density})")

    # the paper's experiment at these densities, over the measured layers
    row = figure7_row(args.bench, model.num_layers, fd, md)
    for line in row_lines(args.bench, row):
        print(line)
    return {"bench": args.bench, "layers": model.num_layers,
            "image_size": args.image_size, "filter_density": fd,
            "map_density": md, "rel_err": rel, "row": row, "stats": stats,
            "output": out, "model": model}


if __name__ == "__main__":
    main()
