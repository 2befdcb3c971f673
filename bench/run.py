"""Run one cell of the benchmark once on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It makes the inputs from the seed, sets up
and warms the port (``repro_torch``) for the cell's shapes only, measures
for ``--seconds``, checks a sample of what the window produced against the
plain reference, and prints one JSON object as the last line of standard
output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, from the harness's spans over the
window and a ``torch.profiler`` trace of its middle stretch (at most
10 s). The numbers compared are printed beside their limits as the last
lines of standard error and under ``checks``, the result's last key.

It exits non-zero and prints no result without a CUDA card, and if JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import arrivals, harness  # noqa: E402
from bench.inputs import make_inputs  # noqa: E402
from bench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def read_metric(name: str, rec: harness.RunRecord):
    """The value of metric ``name`` by its reader, ``metrics/<name>.py``
    (None: nothing to read in this run)."""
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float = T_START, log=sys.stderr):
    """One run: returns the result object (``checks`` last)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, wl, reference = cell.config, cell.workload, cell.reference
    side = max(arrivals.sides_of(cell.traffic))
    filters, pool = make_inputs(cfg, int(cell.traffic["pool"]), side, seed,
                                device)
    pool_np = pool.cpu().numpy()
    model = cell.program.build(cfg, filters, device)
    tracer = Tracer() if trace else None
    rec, samples, program = harness.run_closed(cell, model, pool_np, seed,
                                               seconds, tracer, t_start)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del program, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    pruned = reference.prune_filters(cfg,
                                     [f.cpu().numpy() for f in filters])
    filters_ref = reference.device_filters(pruned, device)
    checks = harness.check(reference, cfg, filters_ref, pool, samples,
                           rec.failed, wl["limits"])
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    if cuda:                  # the peaks are the card's; a CPU run has none
        rec.yardstick = functools.cache(lambda: harness.yardstick(
            reference, cfg, pruned, filters_ref, pool, kind))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": harness.is_correct(checks),
              "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = checks
    print(f"{cell.name} seed {seed}: set-up {rec.setup_s:.3f} s, window "
          f"{rec.window_s:.3f} s, {len(rec.steps)} steps, "
          f"{rec.images_in_window} answers in the window, "
          f"{rec.attempted} attempted, {rec.failed} failed", file=log)
    for k, v in metrics.items():
        print(f"  {k} = {v['value']!r} {v['unit']}", file=log)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark measures the "
              f"port alone", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
