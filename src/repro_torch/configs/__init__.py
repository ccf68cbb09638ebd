from .base import (ENGRAM_27B, EngramConfig, MLAConfig, MambaConfig,
                   ModelConfig, MoEConfig, SpecConfig, StoreConfig,
                   XLSTMConfig, engram_for, get_config, list_archs, register)

__all__ = [
    "ENGRAM_27B", "EngramConfig", "MLAConfig", "MambaConfig", "ModelConfig",
    "MoEConfig", "SpecConfig", "StoreConfig", "XLSTMConfig", "engram_for",
    "get_config", "list_archs", "register",
]
