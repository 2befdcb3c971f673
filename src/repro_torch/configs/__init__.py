"""Model configurations of the reference's ten archs."""
from repro_torch.configs.base import (ARCHS, MambaConfig, ModelConfig,
                                      MoEConfig, load_config, load_smoke)

__all__ = ["ARCHS", "MambaConfig", "ModelConfig", "MoEConfig",
           "load_config", "load_smoke"]
