from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, get_config,
                   get_smoke_config, shape_cells)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "get_smoke_config", "shape_cells"]
