"""Flash attention for Hopper: the wrapper of ``csrc/flash_attention.cu``,
its launch count, and the same function in plain PyTorch.

Model layout throughout: ``q [B, Sq, N, G, D]`` (N kv heads, G query heads
per kv head), ``k/v [B, Sk, N, D]`` -> ``[B, Sq, N, G, D]`` in q's dtype.
``flash_attention_bhsd`` takes the ``[B, H, S, D]`` layout of the TPU kernel
it replaces (``repro/kernels/flash_attention.py``) and hands the same memory
to the same kernel by strides.

For a tensor on the CPU the wrapper computes ``flash_attention_plain``.  For
a CUDA tensor it launches the kernel or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

# Number of kernel launches made by this module (CUDA tensors only).
launches = 0

MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _visible(sq: int, sk: int, causal: bool, window: Optional[int],
             q_offset: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch, all arithmetic in fp32.

    Materialises the ``[B, N, G, Sq, Sk]`` scores.  A query row with no
    visible key returns the mean of v over all Sk keys, as the kernel and
    the oracle ``ref.ref_attention`` do."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bsngd,bknd->bngsk", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = _visible(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None], p,
                    torch.full_like(p, 1.0 / max(k.shape[1], 1)))
    return torch.einsum("bngsk,bknd->bsngd", p, v.float()).to(q.dtype)


def _check(q, k, v, window, softcap):
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,Sq,N,G,D] and k/v "
                         f"[B,Sk,N,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, n, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n \
            or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not belong together")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be >= 0 or None, got {softcap}")


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("flash_attention").flash_attention_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda(name: str, t: torch.Tensor):
    """The kernel reads 4 elements at a time along a contiguous D."""
    vec_bytes = 4 * t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous "
                         f"(strides {t.stride()})")
    if any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % vec_bytes:
        raise ValueError(f"{name}: strides {t.stride()} / address must be "
                         "multiples of 4 elements")


def _launch(q, k, v, out, causal, window, softcap, q_offset):
    global launches
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("the flash-attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    b, sq, n, g, d = q.shape
    sk = k.shape[1]
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"the flash-attention kernel takes head dims that "
                         f"are multiples of 4 up to {MAX_HEAD_DIM}, got {d}")
    if b > 65535 or n * g > 65535:
        raise ValueError(f"batch {b} / heads {n * g} exceed the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_cuda(name, t)
    meta = [b, n, g, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2), q.stride(3),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2), out.stride(3),
            int(bool(causal)), int(window or 0), int(q_offset)]
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 (ctypes.c_longlong * len(meta))(*meta),
                 1.0 / math.sqrt(d), float(softcap or 0.0),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with "
                           f"cudaError {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype})")
    launches += 1


def _attend(q, k, v, out, causal, window, softcap, q_offset):
    """Fills ``out`` (a [B,Sq,N,G,D] view with any strides) and returns it."""
    _check(q, k, v, window, softcap)
    q_offset = int(q_offset)
    if q.numel() == 0:
        return out
    if q.device.type == "cpu":
        out.copy_(flash_attention_plain(q, k, v, causal=causal, window=window,
                                        softcap=softcap, q_offset=q_offset))
    elif q.device.type == "cuda":
        _launch(q, k, v, out, causal, window, softcap, q_offset)
    else:
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not on {q.device}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Model-layout attention: q [B,Sq,N,G,D], k/v [B,Sk,N,D] (any strides
    with a contiguous D) -> a new contiguous [B,Sq,N,G,D].  Query row s sits
    at position ``q_offset + s``; ``q_offset`` is a plain runtime integer."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _attend(q, k, v, out, causal, window, softcap, q_offset)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Attention on q [B,H,Sq,D], k/v [B,Hk,Sk,D] with H a multiple of Hk
    (query head h reads kv head h // (H // Hk)) -> [B,H,Sq,D]."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] % max(1, k.shape[1]):
        raise ValueError("flash_attention_bhsd takes q [B,H,Sq,D] and k/v "
                         f"[B,Hk,Sk,D] with Hk dividing H; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, h, sq, d = q.shape
    hk = k.shape[1]

    def model_layout(t):            # [B,H,Sq,D] -> view [B,Sq,Hk,G,D]
        return t.unflatten(1, (hk, h // hk)).permute(0, 3, 1, 2, 4)

    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _attend(model_layout(q), k.transpose(1, 2), v.transpose(1, 2),
            model_layout(out), causal, window, softcap, q_offset)
    return out
