"""Hand-written CUDA kernels for Hopper (+ plain-torch oracles).

``csrc/`` holds the CUDA C++ sources, ``_build.py`` compiles them with
``nvcc`` at first use, ``_scratch.py`` holds the scratch of the kernels that
finish in a second pass, ``flash_attention.py``, ``rwkv6_scan.py`` and
``cost_reduce.py`` the wrappers, launch counts and plain versions of the
attention, wkv6 and cost-reduction kernels, ``ops.py`` the entries the layers
and the batched DSE backend call, ``ref.py`` the oracles used by the allclose
tests.
"""
from . import ops, ref
from .cost_reduce import cost_reduce_bet, cost_reduce_plain
from .flash_attention import (flash_attention_bhsd, flash_attention_plain)
from .rwkv6_scan import wkv6_bhsd, wkv6_plain

__all__ = ["ops", "ref", "cost_reduce_bet", "cost_reduce_plain",
           "flash_attention_bhsd", "flash_attention_plain",
           "wkv6_bhsd", "wkv6_plain"]
