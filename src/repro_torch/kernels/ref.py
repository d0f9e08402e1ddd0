"""Plain-torch oracle for attention (ground truth for allclose)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive masked softmax attention on [B, H, S, D] tensors, in fp32,
    returned in q's dtype.  Masked scores are -1e30, so a row with no
    visible key averages v over all keys, as the JAX oracle does."""
    d = q.shape[-1]
    s = torch.einsum("bhsd,bhkd->bhsk", q.float(), k.float()) / math.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    sq, sk = q.shape[2], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhsk,bhkd->bhsd", p, v.float()).to(q.dtype)
