"""Flash attention for Hopper: the wrapper of ``csrc/flash_attention.cu``,
its launch count, and the same function in plain PyTorch.

Model layout throughout: ``q [B, Sq, N, G, D]`` (N kv heads, G query heads
per kv head), ``k [B, Sk, N, D]``, ``v [B, Sk, N, Dv]`` -> ``[B, Sq, N, G,
Dv]`` in q's dtype; the scale is ``1/sqrt(D)``.  Dv = D is GQA attention;
Dv < D is MLA's (deepseek-v2: q/k of nope + rope = 192, v of 128), and its
absorbed decode (``models/layers.py:_mla_absorbed``) one query row of 128
heads over one kv head whose key is the 576-wide latent row ``[c_kv |
k_rope]`` and whose value is that row's first 512 columns (the MLA decode
instance, ``"mla"``).
``flash_attention_bhsd`` takes the ``[B, H, S, D]`` layout of the TPU kernel
it replaces (``repro/kernels/flash_attention.py``) and hands the same memory
to the same kernel by strides.  That TPU kernel pads v by q's head dim and
slices the output to it, so it does not compute Dv != D; the port's kernel
does.

For a tensor on the CPU the wrapper computes ``flash_attention_plain``.  For
a CUDA tensor it launches the kernel or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ._scratch import split_scratch

# Number of kernel launches made by this module (CUDA tensors only), and
# the same launches by the kernel ``_variant`` named.
launches = 0
launches_by_variant = {"fma": 0, "tc": 0, "decode": 0, "mla": 0}

# on the card: D (q, k) up to 192, Dv (v, out) up to min(D, 128); above,
# only the MLA decode instance (MLA_D, MLA_DV below)
MAX_HEAD_DIM = 192
MAX_V_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
INPUT_DTYPES = tuple(_DTYPE_CODE)     # of q, k, v on the card
_VARIANT_CODE = {"fma": 0, "tc": 1, "decode": 2, "mla": 3}
# the MLA decode instance: bf16, one query row, one kv head of MLA_D
# columns whose v is its first MLA_DV (the same memory), up to MLA_HEADS
# query heads a block (any G: the last block's rows past G are zeros), one
# block resident per SM
MLA_D, MLA_DV, MLA_HEADS = 576, 512, 64
MLA_DTYPES = (torch.bfloat16,)
MLA_TARGET_BLOCKS = 132
# decode: query heads one block reads a K/V row for (bf16: the 16 rows of
# an mma tile; fp32: 8 lane-group accumulators); a range this short is one
# block's work; blocks a long range is split to (one wave: three resident
# per SM of an H100's 132; two for the bf16 instance at D > 128, whose 88 KB
# of shared memory fit twice); the fewest keys of one split
DECODE_MAX_HEADS = {torch.bfloat16: 16, torch.float32: 8}
DECODE_SHORT_RANGE = 256
DECODE_TARGET_BLOCKS = 3 * 132
DECODE_MIN_SPLIT = 128
_fn = None
_local = threading.local()      # the ctypes meta array, one per thread


def decode_target_blocks(dtype: torch.dtype, d: int) -> int:
    """Blocks of one wave of the decode instance for ``dtype`` and q/k head
    dim ``d``."""
    if dtype == torch.bfloat16 and d > 128:
        return 2 * 132
    return DECODE_TARGET_BLOCKS


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
    """What the kernel computes, in plain PyTorch, all arithmetic in fp32:
    q [B,Sq,N,G,D], k [B,Sk,N,D], v [B,Sk,N,Dv] -> [B,Sq,N,G,Dv].

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
        raise ValueError("flash_attention takes q [B,Sq,N,G,D], k "
                         "[B,Sk,N,D] and v [B,Sk,N,Dv]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, n, _, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[2] != n \
            or k.shape[3] != d or v.shape[3] < 1:
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
                       ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _fits16(esize: int, layouts) -> bool:
    """Every (strides, base address, head dim) of ``layouts`` on 16 bytes
    except the last stride, and every head dim of whole 16-byte pieces."""
    vec = 16 // esize
    return all(
        d % vec == 0 and ptr % 16 == 0
        and all(s % vec == 0 for s in stride[:-1])
        for stride, ptr, d in layouts)


def _rule(sq: int, dtype: torch.dtype, fits: bool) -> str:
    if sq == 1 and fits:
        return "decode"
    if dtype == torch.bfloat16 and fits:
        return "tc"
    return "fma"


def _variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call goes to, by an explicit rule:

    * ``"mla"``: q/k head dim ``MLA_D`` (above the other kernels'
      ``MAX_HEAD_DIM``): MLA's absorbed decode, held to the instance's one
      shape by ``mla_problems``, or the launch raises;
    * ``"decode"``: one query row (Sq = 1) and 16-byte loads fit: D and Dv
      multiples of 16 bytes, every stride but the last and every base
      address on 16 bytes;
    * ``"tc"``: bf16 with more rows and the same fit (the tensor-core
      kernel's TMA boxes and wgmma tiles need it);
    * ``"fma"``: everything else, and fp32 with more rows (IEEE fp32
      arithmetic, never TF32).

    The C entry launches the kernel named here or fails; nothing falls back."""
    if q.shape[-1] > MAX_HEAD_DIM:
        return "mla"
    return _rule(q.shape[1], q.dtype, _fits16(
        q.element_size(),
        [(t.stride(), t.data_ptr(), t.shape[-1]) for t in (q, k, v)]))


def _decode_range(sk: int, causal: bool, window: Optional[int],
                  q_offset: int) -> tuple:
    """The keys ``[lo, hi)`` one query row at ``q_offset`` sees (may be
    empty), as the decode kernel computes them."""
    hi = min(sk, q_offset + 1) if causal else sk
    lo = max(0, q_offset - window + 1) if window else 0
    return lo, hi


def decode_splits(b: int, n: int, visible: int,
                  target: int = DECODE_TARGET_BLOCKS) -> int:
    """Blocks the decode kernel splits ``visible`` keys over, for ``b x n``
    (batch, kv head x chunk of query heads) units.

    One block per unit for a short range (the engine's caches up to a few
    hundred keys): no combine.  A longer range gets as many splits as keep
    every block in one wave of ``target`` blocks (``decode_target_blocks``:
    the instance's resident blocks per SM of an H100: a second, partial wave
    would double the time), but never more splits than whole
    ``DECODE_MIN_SPLIT``-key pieces of the range."""
    if visible <= DECODE_SHORT_RANGE:
        return 1
    fit = target // max(1, b * n)
    return max(1, min(fit, visible // DECODE_MIN_SPLIT))


def _check_layout(name: str, stride: tuple, ptr: int, esize: int, d: int,
                  variant: str):
    """The fma kernel reads 4 elements at a time along a contiguous D; the
    tc and decode kernels read q, k and v 16 bytes at a time."""
    if stride[-1] != 1:
        raise ValueError(f"{name}: the head dim must be contiguous "
                         f"(strides {stride})")
    if any(s % 4 for s in stride[:-1]) or ptr % (4 * esize):
        raise ValueError(f"{name}: strides {stride} / address must be "
                         "multiples of 4 elements")
    if variant != "fma" and name != "out" and not _fits16(
            esize, [(stride, ptr, d)]):
        raise ValueError(f"{name}: the {variant} kernel needs strides "
                         f"{stride}, head dim {d} and address on 16 bytes")


def _check_cuda(name: str, t: torch.Tensor, variant: str = "fma"):
    _check_layout(name, t.stride(), t.data_ptr(), t.element_size(),
                  t.shape[-1], variant)


def mla_problems(q, k, v) -> list:
    """What keeps a call with q/k head dim above ``MAX_HEAD_DIM`` from the
    MLA decode instance ([] if nothing)."""
    b, sq, n, g, d = q.shape
    out = []
    if q.dtype not in MLA_DTYPES:
        out.append(f"dtype {q.dtype} (it takes {MLA_DTYPES})")
    if (d, v.shape[-1]) != (MLA_D, MLA_DV):
        out.append(f"head dims {d}/{v.shape[-1]} (it takes {MLA_D}/{MLA_DV})")
    if sq != 1:
        out.append(f"{sq} query rows (it takes one)")
    if n != 1:
        out.append(f"{n} kv heads (it takes one)")
    if v.data_ptr() != k.data_ptr() or v.stride() != k.stride():
        out.append("v not the leading columns of k")
    return out


def _launch(q, k, v, out, causal, window, softcap, q_offset):
    global launches
    b, sq, n, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    mla = d > MAX_HEAD_DIM
    bad = mla_problems(q, k, v) if mla else []
    if bad:
        raise ValueError(
            f"flash_attention: q/k head dims above {MAX_HEAD_DIM} go to the "
            "MLA decode instance alone, which does not take " + "; ".join(bad))
    if not mla and q.dtype not in _DTYPE_CODE:
        raise TypeError("the flash-attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if not mla and d % 4:
        raise ValueError(f"the flash-attention kernel takes q/k head dims "
                         f"that are multiples of 4 up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if not mla and (dv > min(d, MAX_V_HEAD_DIM) or dv % 4):
        raise ValueError(f"the flash-attention kernel takes v head dims that "
                         f"are multiples of 4 up to min(D, {MAX_V_HEAD_DIM})"
                         f" = {min(d, MAX_V_HEAD_DIM)}, got {dv}")
    if b > 65535 or n * g > 65535:
        raise ValueError(f"batch {b} / heads {n * g} exceed the grid's 65535")
    # strides and addresses read once, for the rule and the checks
    esize = q.element_size()
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    qp, kp, vp, op = q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()
    variant = "mla" if mla else _rule(
        sq, q.dtype, _fits16(esize, [(qs, qp, d), (ks, kp, d), (vs, vp, dv)]))
    for name, st, ptr, width in (("q", qs, qp, d), ("k", ks, kp, d),
                                 ("v", vs, vp, dv), ("out", os_, op, dv)):
        _check_layout(name, st, ptr, esize, width, variant)
    device = q.device
    stream = torch.cuda.current_stream(device).cuda_stream
    splits, split_len, g_chunks = 1, 1, 1
    part = ticket = None
    if variant in ("decode", "mla"):
        g_chunks = -(-g // (MLA_HEADS if mla
                            else DECODE_MAX_HEADS[q.dtype]))
        lo, hi = _decode_range(sk, causal, window, q_offset)
        visible = max(0, hi - lo)
        splits = decode_splits(b, n * g_chunks, visible,
                               MLA_TARGET_BLOCKS if mla
                               else decode_target_blocks(q.dtype, d))
        split_len = max(1, -(-visible // splits))
        if splits > 1:
            units = b * n * g_chunks
            rows = MLA_HEADS if mla else -(-g // g_chunks)   # heads a unit
            part, ticket = split_scratch(
                device, stream, 4 * units * splits * rows * (dv + 2), units)
    meta = getattr(_local, "meta", None)
    if meta is None:
        meta = _local.meta = (ctypes.c_longlong * 27)()
    meta[:] = [b, n, g, sq, sk, d, qs[0], qs[1], qs[2], qs[3],
               ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
               os_[0], os_[1], os_[2], os_[3],
               int(bool(causal)), int(window or 0), int(q_offset),
               splits, split_len, g_chunks, dv]
    args = (qp, kp, vp, op, meta, 1.0 / math.sqrt(d), float(softcap or 0.0),
            _DTYPE_CODE[q.dtype], _VARIANT_CODE[variant], part, ticket, stream)
    fn = _kernel_fn()
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed "
                           f"with cudaError {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype})")
    launches += 1
    launches_by_variant[variant] += 1


def _attend(q, k, v, out, causal, window, softcap, q_offset):
    """Fills ``out`` (a [B,Sq,N,G,Dv] view with any strides) and returns
    it."""
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
    """Model-layout attention: q [B,Sq,N,G,D], k [B,Sk,N,D], v [B,Sk,N,Dv]
    (any strides with contiguous head dims) -> a new contiguous
    [B,Sq,N,G,Dv].  Query row s sits at position ``q_offset + s``;
    ``q_offset`` is a plain runtime integer."""
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    return _attend(q, k, v, out, causal, window, softcap, q_offset)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Attention on q [B,H,Sq,D], k [B,Hk,Sk,D], v [B,Hk,Sk,Dv] with H a
    multiple of Hk (query head h reads kv head h // (H // Hk)) ->
    [B,H,Sq,Dv]."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] % max(1, k.shape[1]):
        raise ValueError("flash_attention_bhsd takes q [B,H,Sq,D] and k/v "
                         f"[B,Hk,Sk,D] with Hk dividing H; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, h, sq, d = q.shape
    hk = k.shape[1]

    def model_layout(t):            # [B,H,Sq,D] -> view [B,Sq,Hk,G,D]
        return t.unflatten(1, (hk, h // hk)).permute(0, 3, 1, 2, 4)

    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    _attend(model_layout(q), k.transpose(1, 2), v.transpose(1, 2),
            model_layout(out), causal, window, softcap, q_offset)
    return out
