"""Host milliseconds per engine step in the graph's copy of the pageable
host batch to the card: the summed ``graph.copy_in`` spans inside the whole
``engine.step`` spans of the traced stretch, over their number. The spans
are the program's (``repro_torch.obs``); without them, nothing."""
from bench.spans import COPY_IN, per_step_ms


def read(run):
    return per_step_ms(run, COPY_IN)
