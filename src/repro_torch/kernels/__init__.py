"""Hand-written CUDA kernels for Hopper (+ plain-torch oracles).

``csrc/`` holds the CUDA C++ sources, ``_build.py`` compiles them with
``nvcc`` at first use, ``flash_attention.py`` and ``rwkv6_scan.py`` the
wrappers, launch counts and plain versions of the attention and wkv6 kernels,
``ops.py`` the model-layout entries the layers call, ``ref.py`` the oracles
used by the allclose tests.
"""
from . import ops, ref
from .flash_attention import (flash_attention_bhsd, flash_attention_plain)
from .rwkv6_scan import wkv6_bhsd, wkv6_plain

__all__ = ["ops", "ref", "flash_attention_bhsd", "flash_attention_plain",
           "wkv6_bhsd", "wkv6_plain"]
