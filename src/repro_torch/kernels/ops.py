"""Public wrappers adapting model-layout tensors to the kernels.

The kernels are forward only: none has a backward, as none of the JAX
package's Pallas kernels has one.  So each entry here refuses to be
differentiated: under grad mode, a floating input that requires grad raises
a ``RuntimeError`` naming the kernel, on every device (on the card the
kernel writes into a fresh tensor through ``ctypes`` and autograd would lose
the graph without a word).  Training goes through the plain PyTorch paths
the models choose by their runtime config (``attention_impl="chunked"``)."""
from __future__ import annotations

from typing import Optional

import torch

from . import cost_reduce as _cr
from . import flash_attention as _fa
from . import rwkv6_scan as _wkv

# the dtypes the attention kernel reads q, k and v in; a caller casts others
FLASH_INPUT_DTYPES = _fa.INPUT_DTYPES


def _refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would have to differentiate ``kernel``."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors
           if t is not None and t.is_floating_point()):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward and an input requires "
            "grad; train through attention_impl='chunked' (the plain "
            "PyTorch paths), or call it under torch.no_grad()")


def cost_reduce(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched cost reduction ``out[b, e] = sum_t x[b, t] * w[e, t]``: the
    busy-group contraction of the batched DSE backend, x [B, K] per-slot
    durations, w [G, K] static membership rows -> [B, G] in x's dtype.

    w is cast to x's dtype, as the JAX wrapper does.  Unlike there, the
    sums run in x's own dtype on the card too (float64 on the batched
    backend's default path, which its 1e-6 parity budget needs; a half x
    in float32); on the CPU the plain version does the same."""
    _refuse_grad("cost_reduce", x, w)
    return _cr.cost_reduce_bet(x, w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Model-layout flash attention: q [B,S,N,G,D], k/v [B,Sk,N,D].

    The kernel reads this layout by strides, so unlike the JAX wrapper there
    is no transpose and no G-fold repeat of k and v on the way in."""
    _refuse_grad("flash_attention", q, k, v)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor, *, chunk: int = 32,
         state_out: Optional[torch.Tensor] = None) -> tuple:
    """Model-layout RWKV6 scan: r/k/v/w [B,S,N,D], u [N,D], state0
    [B,N,D,D] -> (out [B,S,N,D] fp32, final state).

    The kernel reads this layout by strides, so unlike the JAX wrapper there
    are no transposes.  ``state_out`` (the port's addition) receives the final
    state and may be ``state0`` itself, which is then updated in place."""
    _refuse_grad("wkv6", r, k, v, w, u, state0)
    return _wkv.wkv6(r, k, v, w, u, state0, chunk=chunk, state_out=state_out)
