from .base import (ARCHS, PORTED, SHAPES, Arch, ShapeSpec, all_archs, get)

__all__ = ["ARCHS", "PORTED", "SHAPES", "Arch", "ShapeSpec", "all_archs",
           "get"]
