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


def ref_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor) -> tuple:
    """Sequential RWKV6 recurrence on [B, H, S, D]; u [H, D];
    state0 [B, H, D, D].  Returns (out fp32, final state fp32).

        out_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)
        S_t   = diag(w_t) S_{t-1} + k_t^T v_t

    The exact recurrence, without the kernels' intra-chunk decay floor."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    state = state0.float()
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]             # [B,H,D,D]
        outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                 state + u[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(outs, dim=2), state
