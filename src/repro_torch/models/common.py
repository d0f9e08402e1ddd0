"""Shared model infrastructure of the port: runtime config and the
parameter initializer.

Parameters are plain ``torch.Tensor`` leaves in nested dicts/lists with the
same keys and shapes as the JAX package's tree, so weights carry across leaf
by leaf (``models/convert.py``).  Logical sharding axes (``Param.axes``,
``AxisRules``, ``constrain``) wait for the sharding slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .._device import torch_dtype

PyTree = Any


@dataclass(frozen=True)
class RuntimeCfg:
    """Runtime knobs orthogonal to the architecture itself.  The JAX
    package's fields that only sharding and the dry run read (``scan_layers``,
    ``sp``, ``zero1``, ``grad_accum``, ``logical_rules``) come back with
    those slices; ``train.make_train_step`` takes ``grad_accum`` itself."""
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # "cuda": the hand-written kernels, forward only (their plain versions
    # for CPU tensors); "chunked": online-softmax attention and the RWKV6
    # chunk loop in plain PyTorch, what training runs; "naive": materialised
    # scores, the reference the kernel is held against
    attention_impl: str = "cuda"
    attn_chunk: int = 1024              # kv-chunk for online-softmax attention
    attn_q_block: bool = True           # block queries by attn_chunk too
    remat: str = "none"                 # none | full | dots
    loss_chunk: int = 0                 # >0: CE loss over seq chunks
    moe_capacity: float = 1.25          # expert capacity factor


def dt(name) -> torch.dtype:
    return torch_dtype(name)


class Initializer:
    """Deterministic fan-in-scaled normal init on an explicit
    ``torch.Generator``.  Leaves of one dimension are ones (norm scales).
    Normals are drawn in fp32 on the generator's device and cast, so no
    leaf ever exists on the host."""

    def __init__(self, generator: torch.Generator, dtype,
                 device: Optional[torch.device] = None):
        self.generator = generator
        self.dtype = dt(dtype)
        self.device = torch.device(device if device is not None
                                   else generator.device)

    def __call__(self, name: str, shape: tuple, scale: Optional[float] = None,
                 dtype=None) -> torch.Tensor:
        out_dtype = dt(dtype) if dtype is not None else self.dtype
        if len(shape) <= 1:
            return torch.ones(shape, dtype=out_dtype, device=self.device)
        fan_in = shape[0]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        val = torch.randn(shape, generator=self.generator,
                          dtype=torch.float32, device=self.device)
        return val.mul_(std).to(out_dtype)
