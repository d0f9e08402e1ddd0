"""Batched cost reduction for Hopper: the wrapper of ``csrc/cost_reduce.cu``,
its launch count, and the same function in plain PyTorch.

    out[b, e] = sum_t x[b, t] * w[e, t]        x [B, T], w [E, T] -> [B, E]

The dense contraction of the batched DSE backend (``core/batched.py``): x holds
one row of per-slot durations per config, w the static 0/1/k busy-group
membership rows.  It replaces the TPU kernel ``cost_reduce_bet`` of
``repro/kernels/cost_reduce.py``, which accumulates in fp32 whatever its
input; here the kernel accumulates in the input's own type, float32 or
float64, so the batched backend keeps its float64 parity budget on the card.

For tensors on the CPU the wrapper computes ``cost_reduce_plain``.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

# Number of kernel launches made by this module (CUDA tensors only).
launches = 0

_FNS = {torch.float32: "cost_reduce_f32", torch.float64: "cost_reduce_f64"}
_fns: dict = {}


def cost_reduce_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: ``x @ w.T`` in x's dtype."""
    return x @ w.T.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"cost_reduce takes x [B,T] and w [E,T]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} differ "
                         f"in T")
    if x.dtype not in _FNS or w.dtype != x.dtype:
        raise TypeError(f"cost_reduce takes float32 or float64 x and w of one "
                        f"dtype; got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("cost_reduce takes contiguous x and w")


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from . import _build
        fn = getattr(_build.load("cost_reduce"), _FNS[dtype])
        ptr, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ll, ll, ll, ptr]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    (b, t), e = x.shape, w.shape[0]
    out = torch.empty((b, e), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if b > 2 ** 31 - 1 or (e + 7) // 8 > 65535:
        raise ValueError(f"cost_reduce: B {b} / E {e} exceed the grid")
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, e, t, stream)
    if err != 0:
        raise RuntimeError(f"cost_reduce kernel launch failed with cudaError "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"{x.dtype})")
    launches += 1
    return out


def cost_reduce_bet(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[b, e] = sum_t x[b, t] * w[e, t]``: x [B, T], w [E, T] of one
    dtype (float32 or float64), contiguous, on one device -> [B, E] in that
    dtype.  The TPU kernel's name; it takes no block sizes (the kernel needs
    none) and returns the input's dtype, not fp32."""
    _check(x, w)
    if x.device.type == "cpu":
        return cost_reduce_plain(x, w)
    if x.device.type == "cuda":
        return _launch(x, w)
    raise ValueError(f"cost_reduce runs on cuda (kernel) or cpu (plain "
                     f"version), not on {x.device}")
