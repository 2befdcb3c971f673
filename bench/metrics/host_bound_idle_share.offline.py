"""Share of the traced stretch in which no kernel or copy runs on the card
while the host is inside ``engine.admit``, ``engine.assemble``,
``engine.retire`` or ``graph.copy_in``, in percent, by exact overlap: the
part of the card's idle time spent waiting on the engine's host work.
The spans are the program's (``repro_torch.obs``); without an
``engine.step`` span, nothing."""
from bench.spans import COPY_IN, ENGINE_HOST, engine_trace, idle_overlap_s


def read(run):
    t = engine_trace(run)
    if t is None:
        return None
    return 100.0 * idle_overlap_s(t, ENGINE_HOST + COPY_IN) / t.window_s
