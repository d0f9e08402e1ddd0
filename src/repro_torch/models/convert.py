"""Carry a parameter tree of the JAX package across into the port.

The caller strips the JAX package's ``Param`` wrappers and turns every leaf
into a numpy array (``jax.tree.map(np.asarray, pvalue(params))``); this
module never imports jax.  Keys, nesting and shapes are the same in both
packages, so the tree maps leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device, torch_dtype

# leaves the JAX package's init draws in fp32 at any parameter dtype (the
# MoE router: routing is computed in fp32; Mamba's A_log); a cast leaves
# them fp32
FP32_LEAVES = frozenset({"w_router", "A_log"})


def _leaf(a: np.ndarray, device: torch.device,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16: numpy has no native bf16 and torch.from_numpy
        # refuses the extension type, so reinterpret the 16 bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_reference(tree: Any, device=None, dtype=None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    ``torch.Tensor`` on ``device`` (the card unless ``"cpu"``).  ``dtype``
    (name or ``torch.dtype``) casts every floating leaf except those the JAX
    package's init keeps in fp32 whatever the parameter dtype
    (``FP32_LEAVES``: the MoE router ``w_router``, Mamba's ``A_log``), which
    stay fp32 so that a cast tree routes and decays as the reference does;
    None keeps each leaf's own type, bf16 included."""
    device = resolve_device(device)
    want = torch_dtype(dtype) if dtype is not None else None

    def go(node, key=None):
        if isinstance(node, dict):
            return {k: go(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [go(v) for v in node]
        a = np.asarray(node)
        floating = a.dtype.kind == "f" or a.dtype.name == "bfloat16"
        cast = want if floating else None
        if cast is not None and key in FP32_LEAVES:
            cast = torch.float32
        return _leaf(a, device, cast)

    return go(tree)
