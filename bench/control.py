"""The control of a cell's correctness check, on the card at the cell's own
size: the plain reference put in the program's place and computed one
precision lower (TF32 for the configurations' fp32 with TF32 off), then
judged by the same comparison a run makes, on as many answers as a run
compares.

    python3 bench/control.py --workload vgg16.offline_b32 --seeds 1,2,3

Prints one JSON line per seed with the numbers compared and whether the
run would have been judged correct; the control has to come out not
correct. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import arrivals, harness  # noqa: E402
from bench.inputs import make_inputs  # noqa: E402


def control_samples(cell: harness.Cell, seed: int):
    """The requests a run compares, without their answers: (rid, pool
    image, side) by side, as many as its sampled steps hold."""
    wl, tr = cell.workload, cell.traffic
    draws = arrivals.closed_requests(tr, seed)
    side = arrivals.sides_of(tr)[0]
    n = int(wl["sample_steps"]) * int(wl["num_slots"])
    return {side: [(r, next(draws)[0], side) for r in range(n)]}


def control_checks(cell: harness.Cell, seed: int, device,
                   precision: str = "tf32"):
    """The checks of a run whose answers are the reference's at
    ``precision``."""
    cfg, reference = cell.config, cell.reference
    side = max(arrivals.sides_of(cell.traffic))
    filters, pool = make_inputs(cfg, int(cell.traffic["pool"]), side, seed,
                                device)
    pruned = reference.prune_filters(cfg, [f.cpu().numpy() for f in filters])
    ref = reference.device_filters(pruned, device)
    samples = {}
    for size, items in control_samples(cell, seed).items():
        outs = harness.reference_outputs(reference, cfg, ref, pool, items,
                                         size, precision)
        samples[size] = [it + (o.cpu().numpy(),) for it, o in
                         zip(items, outs)]
    return harness.check(reference, cfg, ref, pool, samples, 0,
                         cell.workload["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": "tf32",
                          "correct": harness.is_correct(checks),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
