"""Serving launcher: batched generation or continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
        --sparse --continuous [--requests R] [--slots S] [--stagger K]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \\
        --sparse --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
        --smoke --sparse --continuous --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless_m4t_medium --sparse

The default mode prefills a synthetic prompt batch in one pass and
decodes; ``--continuous`` drives the barrier-free scheduler instead
(staggered arrivals, per-slot positions, slot reuse; decoder-only
models). An encoder-decoder (``seamless_m4t_medium``) encodes stub source
frames, ``0.02 * N(0, 1)`` from ``--seed`` on the device, one per prompt
token, before it generates. ``--sparse`` is the
BARISTA inference mode: ``sparsify_model`` prunes, balances and packs
every FFN (an RWKV model's channel-mix) offline (``num_shards=4``) and
every FFN then runs through the fused FFN kernel and the predicated sparse
matmul, with the skipped-tile stats probed once mid-run. ``--device`` defaults to ``cuda``; wall-clock
numbers from any other device are not the card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import load_config, load_smoke
from repro_torch.models import model as M
from repro_torch.serve import Request, Scheduler, generate
from repro_torch.sparsity.sparse_ffn import sparsify_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="serve staggered requests via the scheduler")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--stagger", type=int, default=2)
    ap.add_argument("--sparse", action="store_true",
                    help="serve through the two-sided sparse FFN kernels")
    ap.add_argument("--density", type=float, default=0.35,
                    help="pruning density for --sparse")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = load_smoke(args.arch) if args.smoke else load_config(args.arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=args.seed, device=dev)
    if args.sparse:
        cfg = dataclasses.replace(cfg, sparse_ffn=True)
        params = sparsify_model(params, cfg, density=args.density,
                                num_shards=4)
    print(f"arch={cfg.name} {cfg.n_layers} layers, {cfg.dtype}, "
          f"sparse={args.sparse}: params ready in "
          f"{time.perf_counter() - t0:.1f} s on {dev}")

    if args.continuous:
        rng = np.random.default_rng(args.seed)
        prompts = rng.integers(1, cfg.vocab,
                               (args.requests, args.prompt_len))
        reqs = [Request(rid=i, prompt=prompts[i], max_new=args.new_tokens,
                        arrival=i * args.stagger)
                for i in range(args.requests)]
        sch = Scheduler(cfg, params, num_slots=args.slots,
                        max_len=args.prompt_len + args.new_tokens)
        produced = sch.run(reqs, probe_ffn=args.sparse)
        st = sch.stats
        print(f"continuous: {args.requests} requests on {args.slots} slots, "
              f"{st.tokens} tokens in {st.wall_s:.2f} s "
              f"({st.tok_per_s:.1f} tok/s incl. first calls, util "
              f"{st.slot_utilization:.2f}) on {dev}")
        probe = sch.ffn_probe
        if probe is not None:
            print(f"sparse FFN: weight-tile density "
                  f"{probe['weight_tile_macs'] / probe['dense_tile_macs']:.2f}"
                  f", activation-side skipped {probe['skipped_frac']:.2f}, "
                  f"executed {probe['executed_frac']:.3f} of dense tile MACs")
        print("sample:", produced[0][:24])
        return

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(1, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    src = None
    if cfg.encoder_layers:
        src = 0.02 * torch.randn((args.batch, args.prompt_len, cfg.d_model),
                                 generator=gen, device=dev)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, args.new_tokens, src_embeds=src)
    out = out.cpu()
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"generated {tuple(out.shape)} in {dt:.2f} s "
          f"({toks / dt:.1f} tok/s incl. first calls) on {dev}")
    print("sample:", out[0, :24].tolist())


if __name__ == "__main__":
    main()
