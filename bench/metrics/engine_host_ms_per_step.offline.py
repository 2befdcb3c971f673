"""Host milliseconds per engine step in the engine's own work: the summed
``engine.admit``, ``engine.assemble`` and ``engine.retire`` spans inside the
whole ``engine.step`` spans of the traced stretch, over their number. The
spans are the program's (``repro_torch.obs``); without them, nothing."""
from bench.spans import ENGINE_HOST, per_step_ms


def read(run):
    return per_step_ms(run, ENGINE_HOST)
