"""Serving. LM: barrier-free continuous batching — ``engine`` holds the
math (per-slot-position decode step, cache-writing single-pass prefill,
slot admit/reset), ``scheduler`` the host request queue and slot table.
Vision: ``vision``, the SLA-aware shape-bucketed image server."""
from repro_torch.serve.engine import (GraphedAdmit, GraphedFfnStats,
                                      GraphedPrefill, GraphedServeStep,
                                      generate, make_admit_fn,
                                      make_ffn_stats_fn, make_prefill_fn,
                                      make_serve_step, reset_slots)
from repro_torch.serve.scheduler import Request, Scheduler, ServeStats
from repro_torch.serve.vision import (RequestRecord, VirtualClock,
                                      VisionServer, VisionServeStats,
                                      WallClock)

__all__ = ["GraphedAdmit", "GraphedFfnStats", "GraphedPrefill",
           "GraphedServeStep", "generate", "make_admit_fn",
           "make_ffn_stats_fn", "make_prefill_fn", "make_serve_step",
           "reset_slots", "Request", "Scheduler", "ServeStats",
           "RequestRecord", "VirtualClock", "VisionServer",
           "VisionServeStats", "WallClock"]
