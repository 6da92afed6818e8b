from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SSMConfig",
    "get_config",
    "get_smoke_config",
]
