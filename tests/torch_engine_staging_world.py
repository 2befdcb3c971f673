"""Two gloo CPU ranks that run ``VisionEngine(mesh=)`` through a closed
loop, for ``tests/test_torch_engine_staging.py``.

    python tests/torch_engine_staging_world.py OUT_DIR [WORLD]

Each rank (one process, one torch thread, a ``file://`` store in
``OUT_DIR``) serves the same requests through the data-sharded engine and
through an unsharded one, keeping twice the slots queued, and writes
``("ok", (steps, staged_hits, staged_misses, answers_equal))`` or
``("failed", traceback)`` to ``OUT_DIR/rank<r>.pkl``. Imports the port
only.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

SLOTS = 4
SIZE = 16
STEPS = 5
GROUP_TIMEOUT_S = 120


def closed_loop(eng, pool):
    """Answers by rid of ``STEPS`` steps with the queue topped up to twice
    the slots before each, then the drain."""
    from repro_torch.vision import ImageRequest
    rid, answers = 0, {}
    for i in range(STEPS):
        while len(eng.queue) < 2 * SLOTS:
            eng.submit(ImageRequest(rid, pool[rid % len(pool)]))
            rid += 1
        assert eng.step()
        answers.update(eng.produced)
        eng.produced.clear()
    while eng.step():
        answers.update(eng.produced)
        eng.produced.clear()
    return answers


def _rank(rank: int, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        from repro_torch.vision import VisionEngine, build_vision_model
        from repro_torch.vision.mesh import data_mesh
        model = build_vision_model("VGGNet", num_layers=2, pattern="chunk",
                                   density=0.4, seed=0, device="cpu")
        rng = np.random.default_rng(3)
        pool = np.abs(rng.normal(size=(6, SIZE, SIZE, 3))).astype(np.float32)
        eng = VisionEngine(model, num_slots=SLOTS,
                           mesh=data_mesh(world, device="cpu"))
        got = closed_loop(eng, pool)
        solo = closed_loop(VisionEngine(model, num_slots=SLOTS), pool)
        equal = sorted(got) == sorted(solo) and all(
            np.array_equal(got[r], solo[r]) for r in solo)
        st = eng.stats
        rec = ("ok", (st.engine_steps, st.staged_hits, st.staged_misses,
                      equal))
    except Exception:                     # recorded for the parent to show
        rec = ("failed", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else argv
    out_dir = os.path.abspath(argv[0])
    world = int(argv[1]) if len(argv) > 1 else 2
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(_rank, args=(world, out_dir), nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
