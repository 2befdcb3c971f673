"""Sparse CNN inference: whole pruned networks through the sparse conv
kernels (``model``) and batched round-robin serving (``engine``)."""
from repro_torch.vision.engine import ImageRequest, VisionEngine, VisionStats
from repro_torch.vision.model import (SUPPORTED_ARCHS, VisionLayer,
                                      VisionModel, build_vision_model,
                                      compile_forward, dense_forward,
                                      forward, layer_geometry, layer_table,
                                      max_pool, measured_densities,
                                      oracle_check, schedule_summary)

__all__ = ["ImageRequest", "VisionEngine", "VisionStats", "SUPPORTED_ARCHS",
           "VisionLayer", "VisionModel", "build_vision_model",
           "compile_forward", "dense_forward", "forward", "layer_geometry",
           "layer_table", "max_pool", "measured_densities", "oracle_check",
           "schedule_summary"]
