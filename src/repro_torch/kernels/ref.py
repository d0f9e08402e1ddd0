"""Plain-torch oracles (ground truth for allclose): attention, the RWKV6
recurrence and the SSM recurrence, each the JAX package's ``kernels/ref``
function of the same name, and the Mamba mixer's selective scan built on
the SSM recurrence (``ref_selective_scan``, the port's own)."""
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


def ref_ssm(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor) -> tuple:
    """Sequential SSM recurrence h_t = dA_t h_{t-1} + dBx_t, one step at a
    time.  dA/dBx [B, S, D, P]; h0 [B, D, P] (cast to dA's dtype) -> (all h
    [B, S, D, P], last h)."""
    h = h0.to(dA.dtype)
    hs = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def ref_selective_scan(dtt: torch.Tensor, xc: torch.Tensor, Bt: torch.Tensor,
                       Ct: torch.Tensor, A_log: torch.Tensor,
                       h0: Optional[torch.Tensor] = None, *,
                       dtype: torch.dtype = torch.float64) -> tuple:
    """The Mamba mixer's selective scan step by step in ``dtype``: A =
    -exp(A_log), dA = exp(dt A), dBx = dt x B, then ``ref_ssm`` and the
    y-contraction y_t = h_t C_t.  dtt/xc [B, S, Din], Bt/Ct [B, S, P],
    A_log [Din, P], h0 [B, Din, P] or None (zero) -> (y [B, S, Din], last h
    [B, Din, P]), both in ``dtype``."""
    dtt, xc, Bt, Ct, A_log = (t.to(dtype) for t in (dtt, xc, Bt, Ct, A_log))
    b, _, din = dtt.shape
    if h0 is None:
        h0 = torch.zeros((b, din, A_log.shape[1]), dtype=dtype,
                         device=dtt.device)
    dA = torch.exp(dtt[..., None] * -torch.exp(A_log))
    dBx = (dtt * xc)[..., None] * Bt[:, :, None, :]
    hs, h = ref_ssm(dA, dBx, h0.to(dtype))
    return torch.einsum("bsip,bsp->bsi", hs, Ct), h
