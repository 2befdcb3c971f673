"""Sparse CNN inference: whole pruned networks through the sparse conv
kernels (``model``), batched round-robin serving (``engine``) and the
shape-bucket helpers of the SLA-aware server (``repro_torch.serve.vision``)."""
from repro_torch.vision.engine import ImageRequest, VisionEngine, VisionStats
from repro_torch.vision.model import (SUPPORTED_ARCHS, VisionLayer,
                                      VisionModel, build_residual_model,
                                      build_vision_model, compile_forward,
                                      dense_forward,
                                      fit_image, forward, graphed_forward,
                                      layer_geometry, layer_table, max_pool,
                                      measured_densities, oracle_check,
                                      route_bucket, schedule_summary)

__all__ = ["ImageRequest", "VisionEngine", "VisionStats", "SUPPORTED_ARCHS",
           "VisionLayer", "VisionModel", "build_residual_model",
           "build_vision_model",
           "compile_forward", "dense_forward", "fit_image", "forward",
           "graphed_forward", "layer_geometry", "layer_table", "max_pool",
           "measured_densities", "oracle_check", "route_bucket",
           "schedule_summary"]
