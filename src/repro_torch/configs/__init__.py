"""Model configurations of the reference's ten archs."""
from repro_torch.configs.base import (ARCHS, SHAPES, MambaConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      load_config, load_smoke)

__all__ = ["ARCHS", "SHAPES", "MambaConfig", "ModelConfig", "MoEConfig",
           "ShapeConfig", "load_config", "load_smoke"]
