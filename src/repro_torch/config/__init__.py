from repro_torch.config.base import (
    ArchConfig,
    MLAConfig,
    MoEConfig,
    PerfFlags,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    reduced_config,
)

__all__ = [
    "ArchConfig",
    "MLAConfig",
    "MoEConfig",
    "PerfFlags",
    "SSMConfig",
    "ShapeConfig",
    "SHAPES",
    "reduced_config",
]
