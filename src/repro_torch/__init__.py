"""PyTorch/CUDA twin of the ``repro`` runtime, for NVIDIA Hopper.

A second package beside the JAX one: it imports ``torch``, sympy and numpy,
never ``jax`` and nothing of ``repro``.  What it needs from a framework-free
module of ``repro`` it keeps as its own copy (the generator in ``core/`` and
``obs/``).  Same sub-package and module names as ``repro`` where a
counterpart exists.

Ported so far — the serving path of dense GQA decoders (qwen3-14b) and of
RWKV6 (rwkv6-7b), and the generator's batched design-space sweep:

    from repro_torch.configs import get
    from repro_torch.models import RuntimeCfg, init_params
    from repro_torch.serve import Engine, Request
    from repro_torch.core import dse       # dse.sweep(..., backend="batched")

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such request they raise.
"""
from ._device import resolve_device, torch_dtype
from .core import MLASpec, ModelSpec, MoESpec, SSMSpec

__all__ = ["resolve_device", "torch_dtype",
           "ModelSpec", "MoESpec", "MLASpec", "SSMSpec"]
