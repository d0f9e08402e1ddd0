"""RWKV6 (Finch) WKV recurrence for Hopper: the wrapper of
``csrc/rwkv6_scan.cu``, its launch count, and the same function in plain
PyTorch.

    out_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t   = diag(w_t) S_{t-1} + k_tᵀ v_t

cut into chunks of ``chunk`` steps, with the intra-chunk decay factorised
under a per-step log-decay floor of ``-80/chunk`` exactly as the TPU kernel it
replaces (``repro/kernels/rwkv6_scan.py``) and the JAX layer's ``_wkv_chunk``
do.  The floor is part of the result: wherever a decay ``w`` is below
``e^{-80/chunk}`` the output differs from the exact recurrence
(``ref.ref_wkv``), so the chunk size is an argument, not a tiling choice.

Model layout throughout: ``r/k/v/w [B, S, N, D]``, ``u [N, D]``,
``state [B, N, D, D]``, all fp32.  ``wkv6_bhsd`` takes the ``[B, N, S, D]``
layout of the TPU kernel and hands the same memory to the same kernel by
strides.

For tensors on the CPU the wrapper computes ``wkv6_plain``.  For CUDA tensors
it launches the kernel or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

# Number of kernel launches made by this module (CUDA tensors only).
launches = 0

HEAD_DIMS = (16, 32, 48, 64)        # the kernel's instances
_fn = None


def _chunk_plain(r, k, v, w, u, state):
    """One chunk, r/k/v/w [B,C,N,D] -> (out [B,C,N,D], new state): the
    arithmetic of ``_wkv_chunk`` / ``_wkv_kernel``, cumulative sums of the
    log-decay and [C, C] scores."""
    C = r.shape[1]
    lw = torch.log(torch.clamp_min(w, 1e-30))            # true decay
    cum = torch.cumsum(lw, dim=1)                        # inclusive
    cum_excl = cum - lw
    inter = torch.einsum("bcnd,bnde->bcne", r * torch.exp(cum_excl), state)
    lwc = torch.clamp_min(lw, -80.0 / C)                 # floored decay
    cumc = torch.cumsum(lwc, dim=1)
    rt = r * torch.exp(cumc - lwc)
    kt = k * torch.exp(-cumc)
    s = torch.einsum("bcnd,bjnd->bncj", rt, kt)
    idx = torch.arange(C, device=r.device)
    s = torch.where(idx[:, None] > idx[None, :], s, torch.zeros_like(s))
    intra = torch.einsum("bncj,bjne->bcne", s, v)
    bonus = torch.sum(r * u * k, dim=-1, keepdim=True) * v
    out = inter + intra + bonus
    total = cum[:, -1]                                   # [B,N,D]
    kdec = k * torch.exp(total[:, None] - cum)
    new_state = state * torch.exp(total)[..., None] \
        + torch.einsum("bjnd,bjne->bnde", kdec, v)
    return out, new_state


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor, *,
               chunk: int, dtype: torch.dtype = torch.float32) -> tuple:
    """What the kernel computes, in plain PyTorch, model layout:
    r/k/v/w [B,S,N,D], u [N,D], state0 [B,N,D,D] -> (out [B,S,N,D], state),
    in fp32 like the TPU kernel.  ``dtype=torch.float64`` computes the same
    function with the factors up to e^{+-80} held exactly enough that its
    error is far below the kernel's (the yardstick ``chip_smoke.py`` holds
    the kernel against)."""
    r, k, v, w, u, state = (t.to(dtype) for t in (r, k, v, w, u, state0))
    outs = []
    for c0 in range(0, r.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        out, state = _chunk_plain(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u,
                                  state)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def _check(r, k, v, w, u, state0, chunk):
    tensors = dict(r=r, k=k, v=v, w=w, u=u, state0=state0)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6 takes float32 tensors; {name} is {t.dtype}")
    if r.dim() != 4:
        raise ValueError(f"wkv6 takes r/k/v/w [B,S,N,D]; r is {tuple(r.shape)}")
    b, s, n, d = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not r's "
                             f"{tuple(r.shape)}")
    if u.shape != (n, d) or state0.shape != (b, n, d, d):
        raise ValueError(f"u {tuple(u.shape)} / state0 {tuple(state0.shape)} "
                         f"do not fit r {tuple(r.shape)}: want u [{n},{d}] "
                         f"and state0 [{b},{n},{d},{d}]")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError("wkv6: all tensors must lie on one device")
    if s < 1 or chunk < 1 or s % chunk:
        raise ValueError(f"the sequence ({s}) must divide into chunks of "
                         f"{chunk}")
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes head dims {HEAD_DIMS}, got {d}")


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("rwkv6_scan").wkv6_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 8 + [ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(r, k, v, w, u, state0, out, state_out, chunk):
    global launches
    b, s, n, d = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6 kernel: {name} needs a contiguous head dim "
                             f"(strides {t.stride()})")
    for name, t in (("u", u), ("state0", state0), ("state_out", state_out)):
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel: {name} must be contiguous")
    if b > 65535 or n > 65535:
        raise ValueError(f"batch {b} / heads {n} exceed the grid's 65535")
    meta = [b, s, n, d, chunk]
    for t in (r, k, v, w, out):
        meta += [t.stride(0), t.stride(1), t.stride(2)]
    fn = _kernel_fn()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state0.data_ptr(), out.data_ptr(),
                 state_out.data_ptr(), (ctypes.c_longlong * len(meta))(*meta),
                 math.exp(-80.0 / chunk), stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed with cudaError {err} "
                           f"(r {tuple(r.shape)}, chunk {chunk})")
    launches += 1


def _scan(r, k, v, w, u, state0, out, state_out, chunk):
    """Fills ``out`` (a [B,S,N,D] view with any strides) and ``state_out``
    (which may be ``state0`` itself) and returns them."""
    _check(r, k, v, w, u, state0, chunk)
    if state_out.shape != state0.shape or state_out.dtype != torch.float32 \
            or state_out.device != state0.device:
        raise ValueError("state_out must be a float32 tensor shaped and "
                         "placed like state0")
    if r.device.type == "cpu":
        got, state = wkv6_plain(r, k, v, w, u, state0, chunk=chunk)
        out.copy_(got)
        state_out.copy_(state)
    elif r.device.type == "cuda":
        _launch(r, k, v, w, u, state0, out, state_out, chunk)
    else:
        raise ValueError(f"wkv6 runs on cuda (kernel) or cpu (plain "
                         f"version), not on {r.device}")
    return out, state_out


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor, *, chunk: int = 32,
         state_out: Optional[torch.Tensor] = None) -> tuple:
    """Model-layout scan: r/k/v/w [B,S,N,D] (any strides with a contiguous
    D), u [N,D], state0 [B,N,D,D] -> (out [B,S,N,D] fp32, final state).

    ``state_out`` receives the final state and is returned; it may be
    ``state0`` itself, which then is **updated in place**.  Without it a new
    tensor is allocated."""
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if state_out is None:
        state_out = torch.empty(state0.shape, dtype=torch.float32,
                                device=state0.device)
    return _scan(r, k, v, w, u, state0, out, state_out, chunk)


def wkv6_bhsd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor, *,
              chunk: int = 64) -> tuple:
    """The TPU kernel's signature: r/k/v/w [B,H,S,D], u [H,D], state0
    [B,H,D,D] -> (out [B,H,S,D] fp32, final state [B,H,D,D] fp32).  As
    there, the chunk is ``min(chunk, S)`` and must divide S."""
    if r.dim() != 4:
        raise ValueError(f"wkv6_bhsd takes r/k/v/w [B,H,S,D]; r is "
                         f"{tuple(r.shape)}")
    chunk = min(chunk, r.shape[2])
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state_out = torch.empty(state0.shape, dtype=torch.float32,
                            device=state0.device)
    tr = lambda t: t.transpose(1, 2)                     # noqa: E731
    _scan(tr(r), tr(k), tr(v), tr(w), u, state0, tr(out), state_out, chunk)
    return out, state_out
