"""Hand-written CUDA kernels for Hopper (+ plain-torch oracles).

``csrc/`` holds the CUDA C++ sources, ``_build.py`` compiles them with
``nvcc`` at first use, ``flash_attention.py`` the wrapper, launch count and
plain version of the attention kernel, ``ops.py`` the model-layout entry the
layers call, ``ref.py`` the oracle used by the allclose tests.
"""
from . import ops, ref
from .flash_attention import (flash_attention_bhsd, flash_attention_plain)

__all__ = ["ops", "ref", "flash_attention_bhsd", "flash_attention_plain"]
