"""Batched cost reduction for Hopper: the wrapper of ``csrc/cost_reduce.cu``,
its launch count, and the same function in plain PyTorch.

    out[b, e] = sum_t x[b, t] * w[e, t]        x [B, T], w [E, T] -> [B, E]

The dense contraction of the batched DSE backend (``core/batched.py``): x holds
one row of per-slot durations per config, w the static 0/1/k busy-group
membership rows.  It replaces the TPU kernel ``cost_reduce_bet`` of
``repro/kernels/cost_reduce.py``, which accumulates in fp32 whatever its
input; here the kernel accumulates in float32 or float64, the input's own
type, so the batched backend keeps its float64 parity budget on the card.

As the reference's wrapper does, w is cast to x's dtype.  x in bfloat16 or
float16 is computed in float32 and the result returned in x's dtype.  Rows
are read by a stride; a tensor whose rows are not contiguous is copied.

For tensors on the CPU the wrapper computes ``cost_reduce_plain``.  For CUDA
tensors it launches the kernel that ``_split`` names or raises; there is no
fallback.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ._scratch import split_scratch

# Number of kernel launches made by this module (CUDA tensors only).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
# outputs per block of the kernel's two instances; config rows per warp
E_TILES = (4, 8)
ROWS = 4
MAX_WARPS = 4
# T is cut into slices of whole granules; the most blocks the rule makes:
# one wave on an H100, 132 SMs x 3 resident blocks (the 8-wide fp64
# instance's 162 registers a thread allow three blocks of 4 warps)
GRANULE = 128
WAVE_BLOCKS = 3 * 132
_fn = None
_local = threading.local()      # the ctypes meta array, one per thread


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the sums run in: float32 and float64 as they are, the
    half types in float32."""
    return dtype if dtype in _DTYPE_CODE else torch.float32


def cost_reduce_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: ``x @ w.T`` with w cast
    to x's dtype, computed in float32 for a half x, returned in x's dtype."""
    ct = _compute_dtype(x.dtype)
    return (x.to(ct) @ w.to(x.dtype).to(ct).T).to(x.dtype)


def slice_len(t: int, slices: int) -> int:
    """Terms of each slice when T terms are cut into ``slices``: whole
    granules, the last slice the short one."""
    granules = -(-t // GRANULE)
    return max(1, -(-granules // slices)) * GRANULE


def cost_reduce_split_plain(x: torch.Tensor, w: torch.Tensor,
                            slices: int) -> torch.Tensor:
    """The kernel's order of summation in plain PyTorch: T cut as the
    kernel cuts it, each slice's partial product, then the slices added in
    slice order.  (Within a slice the kernel's order is its own.)"""
    ct = _compute_dtype(x.dtype)
    xc, wc = x.to(ct), w.to(x.dtype).to(ct)
    step = slice_len(x.shape[1], slices)
    parts = [xc[:, t0:t0 + step] @ wc[:, t0:t0 + step].T
             for t0 in range(0, max(x.shape[1], 1), step)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.to(x.dtype)


def _warps(b: int) -> int:
    """Warps per block: one per ``ROWS`` config rows, at most 4."""
    return min(MAX_WARPS, -(-b // ROWS))


def _split(b: int, e: int, t: int) -> tuple:
    """(slices, e_tile): how a CUDA call is cut, by an explicit rule.

    * ``e_tile``: 4 outputs a block where E is at most 4, else 8 (several
      e-tiles where E is larger).  A warp holds ``ROWS`` config rows, a
      block up to 4 warps (``_warps``).
    * ``slices``: T is cut into slices of whole 128-term granules, as many
      as fit the blocks (slices x row groups x e-tiles) into one wave of
      ``WAVE_BLOCKS``, but never more than T has granules.  At the sweep's
      batches (B up to 18) that is 33 slices of 128 terms, at B = 1024 and
      E = 12 three.

    The C entry launches the kernel this names or fails; nothing falls back."""
    e_tile = E_TILES[0] if e <= E_TILES[0] else E_TILES[1]
    units = -(-b // (ROWS * _warps(b))) * -(-e // e_tile)
    granules = -(-t // GRANULE)
    slices = max(1, min(granules, WAVE_BLOCKS // units))
    if slices > 1:                   # no empty slice at the end
        slices = -(-t // slice_len(t, slices))
    return slices, e_tile


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"cost_reduce takes x [B,T] and w [E,T]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} differ "
                         f"in T")
    if not (x.dtype.is_floating_point and w.dtype.is_floating_point):
        raise TypeError(f"cost_reduce takes floating x and w; got {x.dtype} "
                        f"and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}")


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("cost_reduce").cost_reduce_launch
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ctypes.POINTER(ctypes.c_longlong),
                       c_int, c_int, c_int, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _row_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows are contiguous, else a contiguous copy."""
    return t if t.stride(1) == 1 or t.shape[1] <= 1 else t.contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    x, w = _row_layout(x), _row_layout(w)
    (b, t), e = x.shape, w.shape[0]
    out = torch.empty((b, e), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    slices, e_tile = _split(b, e, t)
    warps = _warps(b)
    device = x.device
    stream = torch.cuda.current_stream(device).cuda_stream
    part = ticket = None
    if slices > 1:
        units = -(-b // (ROWS * warps)) * -(-e // e_tile)
        part, ticket = split_scratch(
            device, stream,
            x.element_size() * units * slices * warps * ROWS * e_tile, units)
    meta = getattr(_local, "meta", None)
    if meta is None:
        meta = _local.meta = (ctypes.c_longlong * 7)()
    meta[:] = [b, e, t, x.stride(0), w.stride(0), slices,
               slice_len(t, slices)]
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), meta,
            _DTYPE_CODE[x.dtype], e_tile, warps, part, ticket, stream)
    fn = _kernel_fn()
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"cost_reduce kernel launch failed with cudaError "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"{x.dtype}, slices {slices}, e_tile {e_tile})")
    launches += 1
    return out


def cost_reduce_bet(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[b, e] = sum_t x[b, t] * w[e, t]``: x [B, T], w [E, T] of any
    floating dtypes and row strides, on one device -> [B, E] in x's dtype.
    The TPU kernel's name; it takes no block sizes (the rule ``_split``
    cuts the work) and returns x's dtype, not fp32."""
    _check(x, w)
    if x.device.type == "cpu":
        return cost_reduce_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"cost_reduce runs on cuda (kernel) or cpu (plain "
                         f"version), not on {x.device}")
    ct = _compute_dtype(x.dtype)
    out = _launch(x.to(ct), w.to(x.dtype).to(ct))
    return out.to(x.dtype)
