"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the record the metrics
read.

The program under test is ``repro_torch``: the benchmark hands the dense
filters it made from the seed to the configuration's program module
(``bench/programs/<program>.py``), which builds the port's network, and
drives ``VisionEngine.step`` in a closed loop. The reference module of
the same topology (``bench/reference/<topology>.py``) prunes the same
dense filters again with its own copy of the rule and runs the network in
plain PyTorch, after the window has closed and the program's state is
freed. The configuration's ``"topology"`` key names both modules; a
configuration without it runs the chain (``chain``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import arrivals
from bench.reference import counts
from bench.trace import Stretch, TraceSummary, Tracer, span

ROOT = Path(__file__).resolve().parents[1]
# how long after the window closes an answer may still come
GRACE_S = 60.0
# rows of one block of the reference's forward
REF_BLOCK = 16
# the gap recorded for an answer of the wrong shape or not finite
NO_ANSWER = 1e30
# the topology where a configuration names none
TOPOLOGY = "chain"
# a topology's program and reference modules: the folder under bench/ and
# the functions each defines
MODULES = (("programs", ("build",)),
           ("reference", ("prune_filters", "device_filters", "forward",
                          "map_bytes")))
STEM = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    workload: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    program: ModuleType
    reference: ModuleType


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m
            or cell in m["workloads"]]


def modules_of(config: Dict, root: Path = ROOT,
               where: str = "the configuration"
               ) -> Tuple[ModuleType, ModuleType]:
    """(program, reference): ``bench/programs/<topology>.py`` and
    ``bench/reference/<topology>.py`` under ``root``, for the topology
    that the configuration's ``"topology"`` key names. Raises
    ``SystemExit``, naming ``where`` and the file, for a name that is not
    a plain identifier, a file that does not exist or a module that lacks
    a function of its interface."""
    stem = config.get("topology", TOPOLOGY)
    if not isinstance(stem, str) or not STEM.fullmatch(stem):
        raise SystemExit(f"{where}: topology {stem!r} is not the stem of a "
                         f"module under bench/programs/ and bench/reference/")
    found = []
    for folder, functions in MODULES:
        rel = f"bench/{folder}/{stem}.py"
        path = root / rel
        if not path.is_file():
            raise SystemExit(f"{where}: topology {stem!r}: no file {rel}")
        name = f"bench_{folder}_{stem}"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        # registered as an import would be: dataclasses look a class's
        # module up in sys.modules
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        missing = [f for f in functions if not callable(getattr(mod, f, None))]
        if missing:
            raise SystemExit(f"{where}: {rel} defines no {', '.join(missing)}")
        found.append(mod)
    return found[0], found[1]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    workload and traffic files, the metrics it reports, and its
    configuration's program and reference modules, all under ``root``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    bench = root / "bench"
    return Cell(
        name, int(w["chips"]), config,
        json.loads((bench / "workloads" / f"{name}.json").read_text()),
        json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        _for_cell(spec["end_to_end"], name),
        _for_cell(spec["per_layer"], name),
        *modules_of(config, root, cfg["file"]))


# ---------------------------------------------------------------------------
# what the metrics read
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RunRecord:
    """Host spans of the window (seconds from its start), its trace and the
    yardstick. ``steps`` holds each step's (start, end, pool images of its
    requests), ``traced_steps`` those that ran under the profiler.
    ``untraced_s`` is the part of the window before the profiler started
    (all of it in an untraced run): host-clock readings of a traced run
    come from it alone, since the profiler's start and its overhead stall
    the loop."""
    kind: str                                  # the traffic's loop
    config: Dict
    setup_s: float
    window_s: float
    images_in_window: int
    steps: List[tuple]
    attempted: int
    failed: int
    trace: Optional[TraceSummary] = None
    traced_steps: List[tuple] = dataclasses.field(default_factory=list)
    untraced_s: Optional[float] = None
    yardstick: Optional[Callable[[], "Yardstick"]] = None


@dataclasses.dataclass
class Yardstick:
    """Two-sided MACs of each pool image at the cell's size, the bytes of
    one image's maps, the non-zero filter bytes, and the card's peaks."""
    macs: np.ndarray                           # int64 [pool]
    map_bytes: int
    weight_bytes: int
    peaks: Dict[str, float]

    def step_bound_s(self, pool_idx) -> float:
        idx = np.asarray(pool_idx, np.int64)
        return counts.forward_bound_s(int(self.macs[idx].sum()), idx.size,
                                      self.map_bytes, self.weight_bytes,
                                      self.peaks)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------
def untraced(run: RunRecord):
    """(seconds, steps) of the part of the window before the profiler
    started: the whole window when nothing was traced."""
    cut = run.window_s if run.untraced_s is None else run.untraced_s
    return cut, [s for s in run.steps if s[1] <= cut]


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the
    seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List[Optional[tuple]] = []

    def slot(self) -> Optional[int]:
        """The place of the next item in the sample, or None: only a
        sampled item is copied."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


# ---------------------------------------------------------------------------
# the closed loop (VisionEngine)
# ---------------------------------------------------------------------------
def run_closed(cell: Cell, model, pool_np: np.ndarray, seed: int,
               seconds: float, tracer: Optional[Tracer], t_start: float):
    from repro_torch.vision.engine import ImageRequest, VisionEngine
    wl, tr = cell.workload, cell.traffic
    if tr["loop"] != "closed":
        raise ValueError(f"the harness runs closed loops, not {tr['loop']!r}")
    sides = arrivals.sides_of(tr)
    if len(sides) != 1 or sides[0] != pool_np.shape[1]:
        raise ValueError("a closed loop serves one image side, the pool's")
    engine = VisionEngine(model, num_slots=int(wl["num_slots"]))
    depth = int(tr["queue_depth"])
    draws = arrivals.closed_requests(tr, seed)
    rid = 0
    pool_of: Dict[int, int] = {}

    def submit(n: int) -> None:
        nonlocal rid
        for _ in range(n):
            idx, _ = next(draws)
            engine.submit(ImageRequest(rid, pool_np[idx]))
            pool_of[rid] = idx
            rid += 1

    # warm-up: the first step builds the work lists, captures the graph
    # and replays it; the rest replay
    for _ in range(int(wl["warm_steps"])):
        submit(engine.num_slots)
        engine.step()
    engine.produced.clear()
    if tracer is not None:
        submit(engine.num_slots)
        tracer.warm(engine.step)
        engine.produced.clear()
    first_rid = rid
    # whole steps are sampled, so every lane of the batch is compared
    reservoir = Reservoir(int(wl["sample_steps"]), arrivals.stream(seed, 3))
    steps: List[tuple] = []
    done = 0

    def collect() -> List[int]:
        nonlocal done
        got = list(engine.produced.items())
        engine.produced.clear()
        j = reservoir.slot() if got else None
        if j is not None:
            reservoir.items[j] = [(r, pool_of[r], pool_np.shape[1],
                                   out.copy()) for r, out in got]
        done += len(got)
        return [pool_of[r] for r, _ in got]

    stretch = Stretch(tracer, seconds)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    images = 0
    while True:
        if len(engine.queue) < depth:
            submit(depth - len(engine.queue))
        stretch.at(time.perf_counter() - t0, len(steps))
        s = time.perf_counter()
        with span("bench.step"):
            engine.step()
        e = time.perf_counter()
        with span("bench.collect"):
            idx = collect()
        images += len(idx)
        steps.append((s - t0, e - t0, idx))
        if e - t0 >= seconds:
            break
    stretch.finish(len(steps))
    t_end = steps[-1][1] + t0
    # drain what was queued; those answers count for the check only
    deadline = time.perf_counter() + GRACE_S
    while not engine.idle and time.perf_counter() < deadline:
        engine.step()
        collect()
    attempted = rid - first_rid
    rec = RunRecord("closed", cell.config, setup_s, t_end - t0, images,
                    steps, attempted, attempted - done, stretch.summary,
                    steps[stretch.steps], stretch.started_at)
    sampled = [it for step in reservoir.items for it in step]
    return rec, {pool_np.shape[1]: sampled}, engine


# ---------------------------------------------------------------------------
# the check against the reference
# ---------------------------------------------------------------------------
def reference_outputs(reference: ModuleType, config: Dict,
                      filters_ref: List[torch.Tensor], pool: torch.Tensor,
                      items: List[tuple], size: int,
                      precision: str = "float32") -> List[torch.Tensor]:
    """The final map by the ``reference`` module of each sampled (rid,
    pool image, side) request, zero-padded to ``size``, on ``pool``'s
    device."""
    outs: List[torch.Tensor] = []
    for b in range(0, len(items), REF_BLOCK):
        block = items[b:b + REF_BLOCK]
        x = torch.zeros(len(block), size, size, pool.shape[-1],
                        device=pool.device)
        for j, it in enumerate(block):
            side = it[2]
            x[j, :side, :side] = pool[it[1], :side, :side]
        outs.extend(reference.forward(config, filters_ref, x,
                                      precision).unbind(0))
    return outs


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / max |ref| of one answer; ``NO_ANSWER`` where that
    is not a finite number."""
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if scale == 0.0:
        return 0.0 if err == 0.0 else NO_ANSWER
    rel = err / scale
    return rel if math.isfinite(rel) else NO_ANSWER


def check(reference: ModuleType, config: Dict,
          filters_ref: List[torch.Tensor], pool: torch.Tensor,
          samples: Dict[int, List[tuple]], failed: int, limits: Dict
          ) -> Dict[str, Dict[str, float]]:
    """The numbers compared, each with its limit: the widest relative gap
    of a sampled answer, and the answers that never came."""
    worst, n = 0.0, 0
    for size, items in samples.items():
        refs = reference_outputs(reference, config, filters_ref, pool,
                                 items, size)
        for it, ref in zip(items, refs):
            out = torch.as_tensor(it[3]).to(ref.device)
            if out.shape != ref.shape:
                worst = NO_ANSWER
            else:
                worst = max(worst, rel_err(out, ref))
            n += 1
    if n == 0:
        worst = NO_ANSWER
    return {"max_rel_err": {"value": worst,
                            "limit": float(limits["max_rel_err"])},
            "sampled": {"value": n, "limit": 1},
            "unanswered": {"value": failed, "limit": 0}}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    c = checks
    return (c["max_rel_err"]["value"] <= c["max_rel_err"]["limit"]
            and c["sampled"]["value"] >= c["sampled"]["limit"]
            and c["unanswered"]["value"] <= c["unanswered"]["limit"])


def yardstick(reference: ModuleType, config: Dict, pruned: List[np.ndarray],
              filters_ref: List[torch.Tensor], pool: torch.Tensor,
              device_name: str) -> Yardstick:
    """Two-sided MACs of every pool image and the bytes of one image's
    maps, by the ``reference`` module."""
    macs = []
    for b in range(0, pool.shape[0], REF_BLOCK):
        per_layer: List[torch.Tensor] = []
        reference.forward(config, filters_ref, pool[b:b + REF_BLOCK],
                          masks_out=per_layer)
        macs.append(torch.stack(per_layer).sum(0).cpu())
    return Yardstick(torch.cat(macs).numpy().astype(np.int64),
                     int(reference.map_bytes(config, int(pool.shape[1]))),
                     counts.filter_bytes(pruned),
                     counts.peaks_for(device_name))
