from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, ShapeSpec, get_config, smoke_config,
)
