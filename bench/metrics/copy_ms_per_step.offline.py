"""Device milliseconds of copies between host and card (and memsets) per
engine step of the traced stretch, from the profiler."""
from bench.trace import is_copy, traced


def read(run):
    t = traced(run, "closed")
    if t is None or not run.traced_steps:
        return None
    return t.device_s(is_copy) / len(run.traced_steps) * 1e3
