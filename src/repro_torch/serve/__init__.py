"""LM serving: barrier-free continuous batching. ``engine`` holds the math
(per-slot-position decode step, cache-writing single-pass prefill, slot
admit/reset); ``scheduler`` the host request queue and slot table."""
from repro_torch.serve.engine import (generate, make_admit_fn,
                                      make_ffn_stats_fn, make_prefill_fn,
                                      make_serve_step, reset_slots)
from repro_torch.serve.scheduler import Request, Scheduler, ServeStats

__all__ = ["generate", "make_admit_fn", "make_ffn_stats_fn",
           "make_prefill_fn", "make_serve_step", "reset_slots", "Request",
           "Scheduler", "ServeStats"]
