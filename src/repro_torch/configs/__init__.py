from .base import ARCHS, PORTED, Arch, get

__all__ = ["ARCHS", "PORTED", "Arch", "get"]
