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
``state [B, N, D, D]``, of any float dtypes, as the TPU kernel casts on
load: the kernels read r, k and v as float32 or bfloat16 (others are cast to
float32 first), w, u and the state as float32, and write a float32 output.
On the card the kernels have head dims ``HEAD_DIMS``; a smaller D is
zero-padded up to the next (``pad_head_dim``, exact).  A D above 128 is
zero-padded to a multiple of 128, as the TPU kernel pads it, and runs on the
D = 128 instances: the recurrence separates by key row (a row of the state
sees only its own k and w, and every output term is a sum over key rows), so
each of the m x m (row block, column block) pairs of the padded D is a D =
128 problem of its own.  ``fold_head_blocks`` makes the pairs heads of one
launch; ``unfold_head_blocks`` adds the partial outputs over the row blocks
in a fixed order and puts the state blocks back (``wkv6_blocked_plain`` is
the same decomposition around the plain version).
On the CPU the plain version takes any D.  ``wkv6_bhsd`` takes the
``[B, N, S, D]`` layout of the TPU kernel and hands the same memory to the
same kernels by strides.

For tensors on the CPU the wrapper computes ``wkv6_plain``.  For CUDA tensors
it launches the kernel that ``_variant`` names (``decode`` for one step,
``tiled`` for more) or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

# Number of kernel launches made by this module (CUDA tensors only), and
# the same launches by the kernel ``_variant`` named.
launches = 0
launches_by_variant = {"decode": 0, "tiled": 0}

HEAD_DIMS = (16, 32, 48, 64, 128)   # the kernels' instances
BLOCK = HEAD_DIMS[-1]               # a wider D runs in blocks of this
INPUT_DTYPES = (torch.float32, torch.bfloat16)   # of r, k, v
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"decode": 0, "tiled": 1}
_fn = None
_local = threading.local()      # the ctypes meta array, one per thread


def _chunk_plain(r, k, v, w, u, state):
    """One chunk, r/k/v/w [B,C,N,D] -> (out [B,C,N,D], new state): the
    arithmetic of ``_wkv_chunk`` / ``_wkv_kernel``, cumulative sums of the
    log-decay and [C, C] scores.  As there, the cumulative sums are products
    with a lower-triangular ones matrix: the factors up to e^{+-80} amplify
    the rounding of those sums, and a sequential ``cumsum`` rounds them
    elsewhere than the reference does."""
    C = r.shape[1]
    lt_incl = torch.tril(torch.ones(C, C, dtype=r.dtype, device=r.device))
    lw = torch.log(torch.clamp_min(w, 1e-30))            # true decay
    cum = torch.einsum("cj,bjnd->bcnd", lt_incl, lw)     # inclusive
    cum_excl = cum - lw
    inter = torch.einsum("bcnd,bnde->bcne", r * torch.exp(cum_excl), state)
    lwc = torch.clamp_min(lw, -80.0 / C)                 # floored decay
    cumc = torch.einsum("cj,bjnd->bcnd", lt_incl, lwc)
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


def _suffix_excl(x: torch.Tensor) -> torch.Tensor:
    """``out[:, i] = prod_{j > i} x[:, j]`` along dim 1, by running products
    from the end (no division)."""
    ones = torch.ones_like(x[:, :1])
    rev = torch.cumprod(torch.flip(x[:, 1:], dims=[1]), dim=1)
    return torch.cat([torch.flip(rev, dims=[1]), ones], dim=1)


def wkv6_tiled_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                     *, chunk: int, tile: int) -> tuple:
    """The ``tiled`` kernel's algorithm in fp32 PyTorch, model layout: the
    same function as ``wkv6_plain``, computed from the same factors as the
    kernel (whose products run as fp32 FMAs or 3xTF32 tensor-core products,
    both of fp32 accuracy).

    Three ``[D, D]`` accumulators are carried (A: the chunk-start state
    decayed by the true w; B: the intra-chunk sum under the floored decay
    wc = max(w, e^{-80/C}); T: the same sum under the true w) and advanced
    ``tile`` steps at a time.  A tile never spans a chunk boundary, so the
    last tile of a chunk may be shorter.  Within a tile, P are running
    prefix products and Sfx running suffix products to the tile's end:

        out   = (r ⊙ Pw_excl) A + (r ⊙ Pwc_excl) B
                + mask_strict((r ⊙ Pwc_excl)(k ⊘ Pwc_incl)ᵀ) V + (r·(u ⊙ k)) v
        T <- diag(Pw_tot) T + (k ⊙ Sfx_w)ᵀ V,  B <- diag(Pwc_tot) B + (k ⊙ Sfx_wc)ᵀ V
        A <- diag(Pw_tot) A;  at a chunk's end A <- A + T, B, T <- 0

    Only the floored products are divided by (times their reciprocal; the
    kernel's is the hardware's approximate one, within 2 ulp): over one
    chunk they stay above e^{-80}, inside fp32's normal range.  The
    true-decay products may underflow (w goes down to 1e-30) and are only
    multiplied.  The bonus term is the diagonal of the score matrix, with k
    replaced by u ⊙ k ⊘ Pwc_excl."""
    f32 = torch.float32
    r, k, v, w, u, state = (t.to(f32) for t in (r, k, v, w, u, state0))
    s = r.shape[1]
    floor = torch.tensor(math.exp(-80.0 / chunk), dtype=f32,
                         device=r.device)
    acc_a = state.clone()
    acc_b = torch.zeros_like(state)
    acc_t = torch.zeros_like(state)
    outs = []
    for c0 in range(0, s, chunk):
        for t0 in range(c0, c0 + chunk, tile):
            sl = slice(t0, min(t0 + tile, c0 + chunk))
            rt, kt, vt = r[:, sl], k[:, sl], v[:, sl]
            wt = torch.clamp_min(w[:, sl], 1e-30)
            wct = torch.maximum(wt, floor)
            ones = torch.ones_like(wt[:, :1])
            pw = torch.cumprod(wt, dim=1)
            pw_excl = torch.cat([ones, pw[:, :-1]], dim=1)
            pwc = torch.cumprod(wct, dim=1)
            pwc_excl = torch.cat([ones, pwc[:, :-1]], dim=1)
            r_a, r_b = rt * pw_excl, rt * pwc_excl
            inv = torch.reciprocal(pwc)
            inv_excl = torch.cat([ones, inv[:, :-1]], dim=1)
            k_q = kt * inv
            k_d = u * kt * inv_excl
            l_ = rt.shape[1]
            sc = torch.einsum("bind,bjnd->bnij", r_b, k_q)
            strict = torch.tril(torch.ones(l_, l_, dtype=torch.bool,
                                           device=r.device), -1)
            sc = torch.where(strict, sc, torch.zeros_like(sc))
            sc = sc + torch.diag_embed(torch.einsum("bind,bind->bni", r_b, k_d))
            out = (torch.einsum("bind,bnde->bine", r_a, acc_a)
                   + torch.einsum("bind,bnde->bine", r_b, acc_b)
                   + torch.einsum("bnij,bjne->bine", sc, vt))
            outs.append(out)
            pw_tot, pwc_tot = pw[:, -1], pwc[:, -1]               # [B,N,D]
            acc_t = acc_t * pw_tot[..., None] + torch.einsum(
                "bjnd,bjne->bnde", kt * _suffix_excl(wt), vt)
            acc_b = acc_b * pwc_tot[..., None] + torch.einsum(
                "bjnd,bjne->bnde", kt * _suffix_excl(wct), vt)
            acc_a = acc_a * pw_tot[..., None]
        acc_a = acc_a + acc_t
        acc_b = torch.zeros_like(state)
        acc_t = torch.zeros_like(state)
    return torch.cat(outs, dim=1), acc_a


def _check(r, k, v, w, u, state0, chunk):
    tensors = dict(r=r, k=k, v=v, w=w, u=u, state0=state0)
    for name, t in tensors.items():
        if not t.dtype.is_floating_point:
            raise TypeError(f"wkv6 takes floating tensors; {name} is "
                            f"{t.dtype}")
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


def _kernel_dtypes(r, k, v, w, u, state0) -> tuple:
    """The inputs as the kernels read them: r, k, v in their dtype where
    they share one of ``INPUT_DTYPES``, else all three in fp32; w, u and
    the state in fp32 (casts, as the TPU kernel casts on load)."""
    if not (r.dtype == k.dtype == v.dtype and r.dtype in INPUT_DTYPES):
        r, k, v = r.float(), k.float(), v.float()
    return (r, k, v, w.float(), u.float(), state0.float())


def head_dim_instance(d: int) -> int:
    """The head dim of the kernel instance a CUDA call of head dim ``d``
    runs at: the smallest of ``HEAD_DIMS`` that holds it (the inputs are
    zero-padded up to it by ``pad_head_dim``); for a D above 128 the D = 128
    instance, run on the ``head_dim_blocks(d)`` x ``head_dim_blocks(d)``
    blocks of D zero-padded to a multiple of 128."""
    return next((inst for inst in HEAD_DIMS if inst >= d), BLOCK)


def head_dim_blocks(d: int) -> int:
    """m: the row (and column) blocks of 128 a head dim ``d`` runs in on the
    card, 1 up to 128."""
    return -(-d // BLOCK)


def fold_head_blocks(r, k, v, w, u, state0, m: int) -> tuple:
    """r/k/v/w [B,S,N,m·128], u [N,m·128], state0 [B,N,m·128,m·128] -> the
    same problem as N·m·m heads of D = 128, head (n, i, j) in that order:
    r, k, w and u of key-row block i, v of value-column block j, and the
    state block (i, j).  Contiguous copies (r, k, w, u m times over, v and
    the state once)."""
    b, s, n, _ = r.shape
    blk = BLOCK

    def rows(t):                    # [B,S,N,m·blk] -> [B,S,N·m·m,blk], by i
        t = t.reshape(b, s, n, m, 1, blk).expand(b, s, n, m, m, blk)
        return t.reshape(b, s, n * m * m, blk)

    def cols(t):                    # [B,S,N,m·blk] -> [B,S,N·m·m,blk], by j
        t = t.reshape(b, s, n, 1, m, blk).expand(b, s, n, m, m, blk)
        return t.reshape(b, s, n * m * m, blk)
    u_f = u.reshape(n, m, 1, blk).expand(n, m, m, blk).reshape(n * m * m, blk)
    state_f = state0.reshape(b, n, m, blk, m, blk).permute(0, 1, 2, 4, 3, 5)
    state_f = state_f.reshape(b, n * m * m, blk, blk)
    return rows(r), rows(k), cols(v), rows(w), u_f, state_f


def unfold_head_blocks(out_f: torch.Tensor, state_f: torch.Tensor,
                       m: int) -> tuple:
    """The inverse of ``fold_head_blocks`` for the results: out_f
    [B,S,N·m·m,128] -> out [B,S,N,m·128], the partial outputs of the row
    blocks i added in the order i = 0, 1, ..., m-1 for every column block;
    state_f [B,N·m·m,128,128] -> state [B,N,m·128,m·128]."""
    b, s = out_f.shape[:2]
    n = out_f.shape[2] // (m * m)
    blk = BLOCK
    parts = out_f.reshape(b, s, n, m, m, blk)
    out = parts[:, :, :, 0]
    for i in range(1, m):
        out = out + parts[:, :, :, i]
    state = state_f.reshape(b, n, m, m, blk, blk).permute(0, 1, 2, 4, 3, 5)
    state = state.reshape(b, n, m * blk, m * blk)
    return out.reshape(b, s, n, m * blk), state


def wkv6_blocked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       state0: torch.Tensor, *, chunk: int,
                       dtype: torch.dtype = torch.float32) -> tuple:
    """What a CUDA call of head dim D > 128 computes, around the plain
    version in place of the kernel: D zero-padded to m·128, the m x m blocks
    folded into heads, ``wkv6_plain`` (``_chunk_plain`` chunk by chunk) on
    them, the partial outputs added over the row blocks in a fixed order and
    the state blocks put back, cut to D.  The same function as
    ``wkv6_plain``; any D."""
    return _blocked(*(t.to(dtype) for t in (r, k, v, w, u, state0)),
                    lambda *heads: wkv6_plain(*heads, chunk=chunk,
                                              dtype=dtype))


def _blocked(r, k, v, w, u, state0, run) -> tuple:
    """D padded to m·128, folded into heads of D = 128, ``run(r, k, v, w, u,
    state0)`` on them, unfolded and cut to D: (out, state)."""
    d = r.shape[-1]
    m = head_dim_blocks(d)
    out_f, state_f = run(*fold_head_blocks(
        *pad_head_dim(r, k, v, w, u, state0, m * BLOCK), m))
    out, state = unfold_head_blocks(out_f, state_f, m)
    return out[..., :d], state[..., :d, :d]


def pad_head_dim(r, k, v, w, u, state0, d_pad: int) -> tuple:
    """r/k/v/w [B,S,N,D], u [N,D], state0 [B,N,D,D] zero-padded to head dim
    ``d_pad``, w with 1, as the TPU kernel pads.  Exact: a padded row of the
    state has k = 0 and decay 1, a padded column v = 0, so both stay zero
    and add nothing to the outputs and state of the first D."""
    p = d_pad - r.shape[-1]
    r, k, v, u = (F.pad(t, (0, p)) for t in (r, k, v, u))
    return r, k, v, F.pad(w, (0, p), value=1.0), u, \
        F.pad(state0, (0, p, 0, p))


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("rwkv6_scan").wkv6_launch
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_float, c_int, c_int, c_int, c_int,
                                   ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _variant(r: torch.Tensor) -> str:
    """The kernel a CUDA call goes to, by an explicit rule:

    * ``"decode"``: one step (S = 1, which forces C = 1): the streaming
      kernel, one block per (batch, head), the state read and written once
      in coalesced float4s;
    * ``"tiled"``: more steps: the tile-stepped walk, one block per (batch,
      head, state-column slice), the state in registers throughout.

    The C entry launches the kernel named here or fails; nothing falls back."""
    return "decode" if r.shape[1] == 1 else "tiled"


def tile_config(d: int, chunk: int) -> tuple:
    """(steps per tile, state columns per block) of the tiled kernel at head
    dim ``d`` and chunk ``chunk``.  (0, d): one tile per chunk, one block per
    head, for chunks of at most 32 steps at head dims 32 and 64 (the
    one-accumulator kernel, which serves C = 32).  Else tiles of 16 steps (a
    tile never spans a chunk boundary) and blocks of 32 state columns at head
    dim 64, 16 at the others."""
    if chunk <= 32 and d in (32, 64):
        return 0, d
    return (16, 32) if d == 64 else (16, 16)


def _check_layout(name: str, stride: tuple, ptr: int, esize: int,
                  variant: str):
    """Every tensor reads its head dim contiguously.  The tiled kernel copies
    r, k and v in 4-byte pieces, so bf16 ones need even strides and a base on
    4 bytes; the decode kernel reads the state in float4s, on 16 bytes."""
    if stride[-1] != 1:
        raise ValueError(f"wkv6 kernel: {name} needs a contiguous head dim "
                         f"(strides {stride})")
    if variant == "tiled" and esize == 2 and (
            ptr % 4 or any(s_ % 2 for s_ in stride[:-1])):
        raise ValueError(f"wkv6 tiled kernel: bf16 {name} needs even strides "
                         f"{stride} and an address on 4 bytes")
    if variant == "decode" and name.startswith("state") and ptr % 16:
        raise ValueError(f"wkv6 decode kernel: {name} needs an address on "
                         "16 bytes")


def _launch(r, k, v, w, u, state0, out, state_out, chunk):
    global launches
    b, s, n, d = r.shape
    variant = _variant(r)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("out", out),
                    ("state0", state0), ("state_out", state_out)):
        _check_layout(name, t.stride(), t.data_ptr(), t.element_size(),
                      variant)
    for name, t in (("u", u), ("state0", state0), ("state_out", state_out)):
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel: {name} must be contiguous")
    if b > 65535 or n > 65535:
        raise ValueError(f"batch {b} / heads {n} exceed the grid's 65535")
    meta = getattr(_local, "meta", None)
    if meta is None:
        meta = _local.meta = (ctypes.c_longlong * 20)()
    meta[:] = [b, s, n, d, chunk, *r.stride()[:3], *k.stride()[:3],
               *v.stride()[:3], *w.stride()[:3], *out.stride()[:3]]
    steps, cols = tile_config(d, chunk)
    device = r.device
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state0.data_ptr(), out.data_ptr(),
            state_out.data_ptr(), meta, math.exp(-80.0 / chunk),
            _DTYPE_CODE[r.dtype], _VARIANT_CODE[variant], steps, cols,
            torch.cuda.current_stream(device).cuda_stream)
    fn = _kernel_fn()
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"wkv6 {variant} kernel launch failed with "
                           f"cudaError {err} (r {tuple(r.shape)} {r.dtype}, "
                           f"chunk {chunk})")
    launches += 1
    launches_by_variant[variant] += 1


def _launch_blocked(r, k, v, w, u, state0, out, state_out, chunk):
    """A head dim D above 128: the m x m blocks of D = 128 as heads of one
    launch of the D = 128 kernel, its results copied back into ``out`` and
    ``state_out`` (``state0`` itself for an in-place call)."""
    def run(*heads):
        out_f = torch.empty(heads[0].shape, dtype=torch.float32,
                            device=r.device)
        state_f = torch.empty(heads[5].shape, dtype=torch.float32,
                              device=r.device)
        _launch(*heads, out_f, state_f, chunk)
        return out_f, state_f
    got, state = _blocked(r, k, v, w, u, state0, run)
    out.copy_(got)
    state_out.copy_(state)


def _scan(r, k, v, w, u, state0, out, state_out, chunk):
    """Fills ``out`` (a [B,S,N,D] view with any strides) and ``state_out``
    (which may be ``state0`` itself) and returns them."""
    _check(r, k, v, w, u, state0, chunk)
    if state_out is state0 and state0.dtype != torch.float32:
        raise TypeError(f"wkv6 updates state0 in place only when it is "
                        f"float32; it is {state0.dtype}")
    if state_out.shape != state0.shape or state_out.dtype != torch.float32 \
            or state_out.device != state0.device:
        raise ValueError("state_out must be a float32 tensor shaped and "
                         "placed like state0")
    args = _kernel_dtypes(r, k, v, w, u, state0)
    d = r.shape[-1]
    if r.device.type == "cpu":
        got, state = wkv6_plain(*args, chunk=chunk)
        out.copy_(got)
        state_out.copy_(state)
    elif r.device.type == "cuda":
        d_pad = head_dim_instance(d)
        if d > BLOCK:
            _launch_blocked(*args, out, state_out, chunk)
        elif d_pad == d:
            _launch(*args, out, state_out, chunk)
        else:
            b, s, n, _ = r.shape
            out_p = torch.empty((b, s, n, d_pad), dtype=torch.float32,
                                device=r.device)
            state_p = torch.empty((b, n, d_pad, d_pad), dtype=torch.float32,
                                  device=r.device)
            _launch(*pad_head_dim(*args, d_pad), out_p, state_p, chunk)
            out.copy_(out_p[..., :d])
            state_out.copy_(state_p[..., :d, :d])
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
    ``state0`` itself, which then is **updated in place** (at a head dim
    above 128 the kernel writes a folded copy, which is copied back into
    it).  Without it a new tensor is allocated."""
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
