"""Model configurations of the archs the port runs."""
from repro_torch.configs.base import (ARCHS, MambaConfig, ModelConfig,
                                      MoEConfig, load_config, load_smoke)

__all__ = ["ARCHS", "MambaConfig", "ModelConfig", "MoEConfig",
           "load_config", "load_smoke"]
