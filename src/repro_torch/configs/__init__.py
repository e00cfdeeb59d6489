from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeCell,
                                     supported_shapes)
from repro_torch.configs.registry import ARCHS, get, reduced

__all__ = ["ArchConfig", "SHAPES", "ShapeCell", "supported_shapes",
           "ARCHS", "get", "reduced"]
