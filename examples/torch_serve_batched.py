"""End-to-end serving example on the PyTorch port (the paper's kind:
inference).

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch rwkv6_3b]
        [--requests 8] [--new-tokens 24] [--smoke] [--sparse] [--device cpu]

Thin client over the barrier-free continuous-batching scheduler
(:class:`repro_torch.serve.Scheduler`): requests arrive staggered, join
free slots through single-pass prefill into a zeroed cache lane, and decode
at per-slot positions, so no slot waits on, or is corrupted by, another
slot's position. Greedy decode is deterministic per request whatever the
batch composition: each request's tokens equal a solo run's.

``--smoke`` shrinks the workload to a CI-sized run and checks that
batch-composition invariance. ``--sparse`` prunes and packs every FFN
(density 0.35) so decoding runs the two-sided sparse FFN kernels.
``--device`` defaults to ``cuda``; ``main(argv)`` returns the tokens and
the serving counters.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import load_smoke
from repro_torch.models import model as M
from repro_torch.serve import Request, Scheduler
from repro_torch.sparsity.sparse_ffn import sparsify_model


def build_requests(rng: np.random.Generator, n: int, prompt_len: int,
                   max_new: int, vocab: int, stagger: int) -> list:
    prompts = rng.integers(1, vocab, (n, prompt_len)).astype(np.int32)
    return [Request(rid=i, prompt=prompts[i], max_new=max_new,
                    arrival=i * stagger) for i in range(n)]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6_3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--stagger", type=int, default=2,
                    help="engine steps between request arrivals")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run + batch-composition invariance check")
    ap.add_argument("--sparse", action="store_true",
                    help="serve through the two-sided sparse FFN kernels")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (default cuda)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.requests, args.slots = 4, 2
        args.prompt_len, args.new_tokens, args.stagger = 4, 6, 1

    device = torch.device(args.device)
    cfg = load_smoke(args.arch)
    params = M.init_params(cfg, seed=0, device=device)
    if args.sparse:
        cfg = dataclasses.replace(cfg, sparse_ffn=True)
        params = sparsify_model(params, cfg, density=0.35, num_shards=4)
    rng = np.random.default_rng(0)
    reqs = build_requests(rng, args.requests, args.prompt_len,
                          args.new_tokens, cfg.vocab, args.stagger)
    max_len = args.prompt_len + args.new_tokens

    sch = Scheduler(cfg, params, num_slots=args.slots, max_len=max_len)
    produced = sch.run(reqs)
    st = sch.stats
    print(f"arch={cfg.name} served {args.requests} requests on {args.slots} "
          f"slots on {device}: {st.tokens} tokens in {st.wall_s:.1f}s "
          f"({st.engine_steps} engine steps, {st.prefills} prefills, "
          f"{st.tok_per_s:.1f} tok/s incl. first calls, "
          f"slot utilization {st.slot_utilization:.2f})")
    for r in range(min(3, args.requests)):
        print(f"  req{r}: {produced[r][:10]}")

    if args.smoke:
        # batch-composition invariance: every request solo must reproduce
        # its continuous-batch tokens exactly
        for r in reqs:
            solo = Scheduler(cfg, params, num_slots=args.slots,
                             max_len=max_len)
            got = solo.run([Request(rid=r.rid, prompt=r.prompt,
                                    max_new=r.max_new, arrival=0)])[r.rid]
            if got != produced[r.rid]:
                raise RuntimeError(f"req{r.rid}: solo {got} != batched "
                                   f"{produced[r.rid]}")
        print("smoke OK: per-request outputs invariant to batch composition")
    return {"produced": produced, "tokens": st.tokens,
            "engine_steps": st.engine_steps, "prefills": st.prefills,
            "slot_utilization": st.slot_utilization}


if __name__ == "__main__":
    main()
