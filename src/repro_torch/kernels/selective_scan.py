"""Selective scan of the Mamba mixer for Hopper: the wrapper of
``csrc/selective_scan.cu``, its launch count, and the same function in plain
PyTorch.

    A     = -exp(A_log)                                   [Din, P]
    h_t   = exp(dt_t A) ⊙ h_{t-1} + (dt_t x_t) B_t        [Din, P] a batch row
    y_t   = h_t C_t                                       [Din]

from ``h0`` (zero where none is given), in fp32, y rounded once to x's dtype;
also the last h in fp32.  Layout: ``dtt [B, S, Din]`` fp32, ``xc [B, S, Din]``,
``Bt`` and ``Ct [B, S, P]`` in one of ``INPUT_DTYPES`` (B and C in x's), each
read by its strides with a contiguous last dim (the layer's strided views of
``xdb`` are taken as they are), ``A_log [Din, P]`` and ``h0 [B, Din, P]`` fp32.

The JAX package has no kernel here: its Mamba mixer runs the scan as plain
JAX over ``jax.lax.associative_scan`` (``repro/models/layers.py``), and
``selective_scan_plain`` is the port's copy of that span, the same pairs
combined in the same order.  The kernel (notes in its source) walks each
chunk of the sequence step by step and carries the chunks' states as the
plain path does; ``split`` is the rule that cuts the sequence.

For CPU, meta and fake tensors (the dry run's) the wrapper computes
``selective_scan_plain``.  For real CUDA tensors it launches the kernel or
raises; there is no fallback.  The kernel has no backward and reads
``data_ptr()``: its entry (``kernels/ops.py``) refuses an input that requires
grad and hands it each rank's local shard on a mesh.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from ..models.common import einsum, mesh_of
from ._scratch import split_scratch

# Number of kernel launches made by this module (CUDA tensors only).
launches = 0

INPUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # x, B, C, y
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
STATES = 16            # the kernel's most states a channel
THREADS = 128          # channels a block of the kernel
THREADS_PER_SM = 512   # what ``split`` aims to give each SM where it cuts
MIN_CHUNK = 64         # the shortest chunk ``split`` cuts
_fn = None
_local = threading.local()      # the ctypes meta array, one per thread


def _combine(a1, x1, a2, x2) -> tuple:
    """(a1, x1) then (a2, x2): h -> a2 (a1 h + x1) + x2."""
    return a1 * a2, x1 * a2 + x2


def _associative_scan(a: torch.Tensor, x: torch.Tensor) -> tuple:
    """Inclusive scan of ``_combine`` over dim 1, by the odd/even recursion
    of ``jax.lax.associative_scan`` (log depth, the same pairs combined in
    the same order, so the same roundings)."""
    n = a.shape[1]
    if n < 2:
        return a, x
    odd_a, odd_x = _associative_scan(*_combine(a[:, 0:-1:2], x[:, 0:-1:2],
                                               a[:, 1::2], x[:, 1::2]))
    if n % 2 == 0:
        ev_a, ev_x = _combine(odd_a[:, :-1], odd_x[:, :-1], a[:, 2::2],
                              x[:, 2::2])
    else:
        ev_a, ev_x = _combine(odd_a, odd_x, a[:, 2::2], x[:, 2::2])

    def interleave(first, even, odd):
        out = first.new_empty((first.shape[0], n) + tuple(first.shape[2:]))
        out[:, 0:1] = first
        out[:, 2::2] = even
        out[:, 1::2] = odd
        return out

    return (interleave(a[:, :1], ev_a, odd_a),
            interleave(x[:, :1], ev_x, odd_x))


def _ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor,
              chunk: int) -> tuple:
    """h_t = dA_t * h_{t-1} + dBx_t over dim 1; returns (all h, last h).

    dA/dBx: [B, S, D, P]; h0 [B, D, P].  The JAX package's chunking: chunks
    of ``chunk`` steps carried one after the other, one chunk of S when
    ``chunk`` does not divide S; a log-depth scan inside each chunk."""
    s = dA.shape[1]
    if s % chunk != 0:
        chunk = s
    # a write through ``out=`` has no backward: where autograd records, the
    # chunks (the same sums) are joined instead, as they are on a mesh,
    # where a view of a DTensor cannot take a result of other placements
    joined = (torch.is_grad_enabled() and any(
        t.requires_grad for t in (dA, dBx, h0))) or mesh_of(dBx) is not None
    hs = None if joined else torch.empty_like(dBx)
    parts = []
    h = h0
    for c0 in range(0, s, chunk):
        aa, xx = _associative_scan(dA[:, c0:c0 + chunk],
                                   dBx[:, c0:c0 + chunk])
        if joined:
            part = xx + aa * h[:, None]
            parts.append(part)
        else:
            part = torch.add(xx, aa * h[:, None], out=hs[:, c0:c0 + chunk])
        h = part[:, -1]
    return (torch.cat(parts, dim=1) if joined else hs), h


def selective_scan_plain(dtt: torch.Tensor, xc: torch.Tensor,
                         Bt: torch.Tensor, Ct: torch.Tensor,
                         A_log: torch.Tensor,
                         h0: Optional[torch.Tensor]) -> tuple:
    """The function in plain PyTorch, as the JAX package's Mamba mixer
    computes it: dA and dBx built as [B, S, Din, P] fp32 tensors, the
    chunked log-depth scan ``_ssm_scan`` (chunks of ``min(S, 256)``), the
    y-contraction -> (y [B, S, Din] in xc's dtype, last h [B, Din, P]).
    Any layout, any floating dtypes; autograd and DTensors go through."""
    b, s, din = dtt.shape
    A = -torch.exp(A_log.float())                              # [Din, P]
    dA = torch.exp_(dtt[..., None] * A)                        # [B,S,Din,P]
    dBx = (dtt * xc.float())[..., None] * Bt[:, :, None, :].float()
    if h0 is None:
        h0 = torch.zeros((b, din, A.shape[1]), dtype=torch.float32,
                         device=dtt.device)
    hs, h_last = _ssm_scan(dA, dBx, h0, chunk=min(s, 256))
    y = einsum("bsip,bsp->bsi", hs, Ct.float()).to(xc.dtype)
    return y, h_last


def split(b: int, s: int, d: int, sms: int) -> tuple:
    """(chunks n, chunk length L) of a CUDA call.  The kernel gives a thread
    to each (batch row, channel, chunk), and a sequence cut into chunks is
    walked twice (each chunk from zero, then again from its true start): that
    pays only where the batch rows alone would leave SMs without a block.  So
    one chunk where B x Din fills a block of ``THREADS`` a SM; else the whole
    number of chunks nearest to ``THREADS_PER_SM`` threads a SM (none
    shorter than ``MIN_CHUNK`` steps, at least one), the last chunk the
    shortest.  At Din 8192 on 132 SMs: 8 chunks at B = 1, 4 at B = 2, and
    one at B = 4, B = 8 and for every decode step."""
    per_chunk = b * d
    if per_chunk >= THREADS * sms:
        return 1, s
    n = (sms * THREADS_PER_SM + per_chunk // 2) // per_chunk
    n = max(1, min(n, s // MIN_CHUNK))
    length = -(-s // n)
    return -(-s // length), length


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(dtt, xc, Bt, Ct, A_log, h0) -> None:
    """Shapes, dtypes and device of a call, on every device."""
    if dtt.dim() != 3 or A_log.dim() != 2:
        raise ValueError(f"selective_scan takes dtt [B,S,Din] and A_log "
                         f"[Din,P]; got {tuple(dtt.shape)} and "
                         f"{tuple(A_log.shape)}")
    b, s, din = dtt.shape
    p = A_log.shape[1]
    want = {"xc": (xc, (b, s, din)), "Bt": (Bt, (b, s, p)),
            "Ct": (Ct, (b, s, p)), "A_log": (A_log, (din, p))}
    if h0 is not None:
        want["h0"] = (h0, (b, din, p))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} is {tuple(t.shape)}, "
                             f"want {list(shape)} (dtt {tuple(dtt.shape)}, "
                             f"P {p})")
    for name, t in (("dtt", dtt), ("A_log", A_log), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"selective_scan takes {name} in float32, not "
                            f"{t.dtype}")
    if xc.dtype not in INPUT_DTYPES or Bt.dtype != xc.dtype \
            or Ct.dtype != xc.dtype:
        raise TypeError(f"selective_scan takes xc, Bt and Ct in one of "
                        f"{INPUT_DTYPES}; got {xc.dtype}, {Bt.dtype}, "
                        f"{Ct.dtype}")
    tensors = [t for t in (dtt, xc, Bt, Ct, A_log, h0) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("selective_scan: all tensors must lie on one device")


def _check_kernel(dtt, xc, Bt, Ct, A_log, h0) -> None:
    """What the kernel takes beyond ``_check``: a contiguous last dim where
    it reads by strides; A_log and the state read whole (contiguous), with
    at most ``STATES`` states a channel."""
    if A_log.shape[-1] > STATES:
        raise ValueError(f"selective_scan kernel: at most {STATES} states a "
                         f"channel, got {A_log.shape[-1]}")
    for name, t in (("dtt", dtt), ("xc", xc), ("Bt", Bt), ("Ct", Ct)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"selective_scan kernel: {name} needs a "
                             f"contiguous last dim (strides {t.stride()})")
    for name, t in (("A_log", A_log), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"selective_scan kernel: {name} must be "
                             "contiguous")


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("selective_scan").selective_scan_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 10 + [ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(dtt, xc, Bt, Ct, A_log, h0, y, h_out) -> None:
    """y [B, S, Din] and h_out [B, Din, P] or None: new contiguous tensors."""
    global launches
    b, s, d = dtt.shape
    p = A_log.shape[1]
    device = dtt.device
    stream = torch.cuda.current_stream(device).cuda_stream
    n, length = split(b, s, d, _sm_count(device.index))
    ends = sync = None
    if n > 1:
        tiles = -(-d // THREADS)
        ends, sync = split_scratch(device, stream, 4 * b * n * d * p,
                                   2 + b * n * tiles)
    meta = getattr(_local, "meta", None)
    if meta is None:
        meta = _local.meta = (ctypes.c_longlong * 16)()
    meta[:] = [b, s, d, p, n, length, *dtt.stride()[:2], *xc.stride()[:2],
               *Bt.stride()[:2], *Ct.stride()[:2], *y.stride()[:2]]
    ptr = lambda t: None if t is None else t.data_ptr()     # noqa: E731
    args = (dtt.data_ptr(), xc.data_ptr(), Bt.data_ptr(), Ct.data_ptr(),
            A_log.data_ptr(), ptr(h0), y.data_ptr(), ptr(h_out), ends, sync,
            meta, _DTYPE_CODE[xc.dtype], stream)
    fn = _kernel_fn()
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed with "
                           f"cudaError {err} (dtt {tuple(dtt.shape)}, P {p}, "
                           f"{xc.dtype}, {n} chunks of {length})")
    launches += 1


def selective_scan(dtt: torch.Tensor, xc: torch.Tensor, Bt: torch.Tensor,
                   Ct: torch.Tensor, A_log: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   state: bool = True) -> tuple:
    """-> (y [B, S, Din] in xc's dtype, the last state [B, Din, P] fp32, or
    None where ``state`` is False: a prefill that keeps no cache skips
    writing it)."""
    from torch._subclasses.fake_tensor import is_fake
    _check(dtt, xc, Bt, Ct, A_log, h0)
    if dtt.device.type in ("cpu", "meta") or is_fake(dtt):
        y, h_last = selective_scan_plain(dtt, xc, Bt, Ct, A_log, h0)
        return y, (h_last if state else None)
    if dtt.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda (kernel) or cpu, meta "
                         f"and fake tensors (plain version), not on "
                         f"{dtt.device}")
    _check_kernel(dtt, xc, Bt, Ct, A_log, h0)
    b, s, d = dtt.shape
    y = torch.empty((b, s, d), dtype=xc.dtype, device=dtt.device)
    h_out = torch.empty((b, d, A_log.shape[1]), dtype=torch.float32,
                        device=dtt.device) if state else None
    _launch(dtt, xc, Bt, Ct, A_log, h0, y, h_out)
    return y, h_out
