"""Quickstart on the PyTorch port: the BARISTA pipeline end to end.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Build a small transformer with a squared-ReLU FFN (the nemotron smoke
   config: natural activation sparsity, the transformer analogue of the
   paper's post-ReLU feature maps).
2. Prune one block's FFN weights to a paper-like density.
3. Greedy-balance the hidden channels across shards and pack them into the
   chunk-block-sparse format.
4. Run the two-sided sparse FFN (K4 then K3 on the card, their plain
   versions on the CPU) and check it against the dense oracle: sparsity is
   exact, not approximate.
5. Ask the cycle model what this density buys at 32K-MAC scale.

``--device`` defaults to ``cuda``; ``main(argv)`` returns the numbers it
prints.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import load_smoke
from repro_torch.core import simulator as S
from repro_torch.models import model as M
from repro_torch.sparsity import instrument
from repro_torch.sparsity import sparse_ffn as sf


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the FFN runs on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # 1. model with a relu^2 FFN (nemotron-family smoke config)
    cfg = load_smoke("nemotron_4_340b")
    params = M.init_params(cfg, seed=0, device=device)
    print(f"model: {cfg.name}  d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"act={cfg.act}")

    # 2.-3. prune + balance + pack one block's FFN
    blk = params["blocks"][0]["p0"]["ffn"]
    density = 0.35  # paper Table 1 territory
    ffn = sf.build_sparse_ffn(blk, cfg.act, density=density, num_shards=4,
                              device=device)
    print(f"pruned FFN to {density:.0%} density; "
          f"w_in chunk-density={ffn.w_in.density():.2f}")

    # 4. two-sided sparse FFN against the dense oracle
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(32, cfg.d_model)).astype(np.float32),
                        device=device)
    sparse_out = ffn(x)
    dense_out = sf.dense_reference(ffn, x)
    err = float((sparse_out - dense_out).abs().max())
    rel = err / max(float(dense_out.abs().max()), 1e-30)
    print(f"two-sided sparse FFN vs oracle: max |err| = {err:.2e} "
          f"(rel {rel:.2e})")

    # the activation sparsity the two-sided path exploits
    h = torch.relu(x @ blk["w_in"].float()) ** 2
    probe = {k: float(v) for k, v in
             instrument.ffn_sparsity_probe(h).items()}
    print(f"post-relu^2 activation density: scalar={probe['scalar']:.2f} "
          f"tile128={probe['tile_128']:.2f}")

    # 5. what it buys at scale (the cycle model, measured densities)
    bench = S.Benchmark("quickstart", S.BENCHMARKS["VGGNet"].layers,
                        density, probe["scalar"])
    dense_c = S.simulate(bench, "Dense").cycles
    speedups = {}
    for scheme in ("One-sided", "SparTen", "Synchronous", "BARISTA"):
        speedups[scheme] = dense_c / S.simulate(bench, scheme).cycles
        print(f"  {scheme:12s} speedup over Dense at 32K MACs: "
              f"{speedups[scheme]:4.1f}x")
    return {"max_abs_err": err, "rel_err": rel, "probe": probe,
            "speedups": speedups, "w_in_chunk_density": ffn.w_in.density()}


if __name__ == "__main__":
    main()
