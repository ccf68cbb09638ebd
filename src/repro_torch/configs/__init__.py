from .base import (ENGRAM_27B, ENGRAM_40B, SHAPES, EngramConfig, MLAConfig,
                   MambaConfig, ModelConfig, MoEConfig, ShapeConfig,
                   SpecConfig, StoreConfig, XLSTMConfig, applicable_shapes,
                   engram_for, get_config, list_archs, register,
                   skipped_shapes)

__all__ = [
    "ENGRAM_27B", "ENGRAM_40B", "SHAPES", "EngramConfig", "MLAConfig",
    "MambaConfig", "ModelConfig", "MoEConfig", "ShapeConfig", "SpecConfig",
    "StoreConfig", "XLSTMConfig", "applicable_shapes", "engram_for",
    "get_config", "list_archs", "register", "skipped_shapes",
]
