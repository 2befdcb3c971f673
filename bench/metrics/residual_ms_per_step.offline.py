"""Device milliseconds of K1's launches whose flush adds a shortcut
(``tile_kernel_residual``, a ResNet block's last conv) per engine step of
the traced stretch, from the profiler; None where the trace holds none."""
from bench.trace import traced

RESIDUAL = "tile_kernel_residual"


def read(run):
    t = traced(run, "closed")
    if t is None or not run.traced_steps:
        return None
    ms = t.device_s(lambda n: RESIDUAL in n)
    if ms <= 0:
        return None
    return ms / len(run.traced_steps) * 1e3
