"""Share of the traced stretch in which no kernel or copy ran on the card,
in percent (the engine's cells)."""
from bench.trace import traced


def read(run):
    t = traced(run, "closed")
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
