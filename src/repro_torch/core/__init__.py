"""The part of the generator's ``core`` that the runtime needs: the model
specification dataclasses.  The symbolic pipeline itself is not ported yet."""
from .assemble import MLASpec, ModelSpec, MoESpec, SSMSpec

__all__ = ["ModelSpec", "MoESpec", "MLASpec", "SSMSpec"]
