"""Shared model infrastructure of the port: runtime config and the
parameter initializer.

Parameters are plain ``torch.Tensor`` leaves in nested dicts/lists with the
same keys and shapes as the JAX package's tree, so weights carry across leaf
by leaf (``models/convert.py``).  Every leaf is created with its logical
axes, as in the JAX package; the port keeps them apart from the tensors, in
a tree of the same structure (``lm.param_axes``, built by running the same
init functions through ``AxesInitializer``).  ``AxisRules`` and
``constrain`` wait for the sharding slice.
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


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists/tuples (lists out)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _check_axes(name: str, shape: tuple, axes: tuple) -> None:
    if len(axes) != len(shape):
        raise ValueError(f"{name}: {len(shape)} dimensions {shape} but axes "
                         f"{axes}")


class Initializer:
    """Deterministic fan-in-scaled normal init on an explicit
    ``torch.Generator``.  Leaves of one dimension are ones (norm scales).
    Normals are drawn in fp32 on the generator's device and cast, so no
    leaf ever exists on the host.  ``axes`` (one logical name per
    dimension) is checked and not stored: ``AxesInitializer`` collects it."""

    def __init__(self, generator: torch.Generator, dtype,
                 device: Optional[torch.device] = None):
        self.generator = generator
        self.dtype = dt(dtype)
        self.device = torch.device(device if device is not None
                                   else generator.device)

    def __call__(self, name: str, shape: tuple, axes: tuple,
                 scale: Optional[float] = None, dtype=None) -> torch.Tensor:
        _check_axes(name, shape, axes)
        out_dtype = dt(dtype) if dtype is not None else self.dtype
        if len(shape) <= 1:
            return torch.ones(shape, dtype=out_dtype, device=self.device)
        fan_in = shape[0]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        val = torch.randn(shape, generator=self.generator,
                          dtype=torch.float32, device=self.device)
        return val.mul_(std).to(out_dtype)

    @staticmethod
    def stack(init_one, n_rep: int) -> dict:
        """``n_rep`` subtrees ``init_one(r)`` stacked ``[n_rep, ...]``,
        filled one layer at a time so that the fp32 draw of only one layer
        is alive beside the stack."""
        stack: dict = {}
        for r in range(n_rep):
            rep = init_one(r)
            if r == 0:
                stack = _tree_map(
                    lambda t: torch.empty((n_rep,) + tuple(t.shape),
                                          dtype=t.dtype, device=t.device),
                    rep)
            _tree_map(lambda dst, src: dst[r].copy_(src), stack, rep)
        return stack


class AxesInitializer:
    """``Initializer``'s stand-in that builds no tensor: each call returns
    the leaf's logical axes, and ``stack`` prepends ``"layers"`` to every
    leaf of a stacked subtree, as the JAX package's ``lm._stack`` does.  Run
    through the init functions that build the parameter tree, it builds the
    tree of axes, so the two trees cannot drift apart."""

    def __call__(self, name: str, shape: tuple, axes: tuple,
                 scale: Optional[float] = None, dtype=None) -> tuple:
        _check_axes(name, shape, axes)
        return tuple(axes)

    @staticmethod
    def stack(init_one, n_rep: int) -> dict:
        return _prepend_layers(init_one(0)) if n_rep else {}


def _prepend_layers(node):
    if isinstance(node, dict):
        return {k: _prepend_layers(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_prepend_layers(v) for v in node]
    return ("layers",) + node
