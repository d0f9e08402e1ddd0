"""Public wrappers adapting model-layout tensors to the kernels."""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Model-layout flash attention: q [B,S,N,G,D], k/v [B,Sk,N,D].

    The kernel reads this layout by strides, so unlike the JAX wrapper there
    is no transpose and no G-fold repeat of k and v on the way in."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)
