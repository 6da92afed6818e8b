from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    all_cells,
    cells,
    get_config,
    get_smoke_config,
    skipped_cells,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SSMConfig",
    "all_cells",
    "cells",
    "get_config",
    "get_smoke_config",
    "skipped_cells",
]
