"""Twice the two-sided MACs of the images completed in the window, over the
window's seconds times the card's fp32 peak, in percent; in a traced run,
of the part of the window before the profiler started. The MACs are the
reference's count for each pool image (``bench/reference/counts.py``),
whatever the program executes."""
import numpy as np

from bench.harness import untraced


def read(run):
    if run.kind != "closed" or run.yardstick is None:
        return None
    seconds, steps = untraced(run)
    if not steps or seconds <= 0:
        return None
    y = run.yardstick()
    idx = np.concatenate([np.asarray(s[2], np.int64) for s in steps])
    flops = 2.0 * float(y.macs[idx].sum())
    return 100.0 * flops / (seconds * y.peaks["float32_flops"])
