"""Layer library of the port: norms, RoPE, attention cores, the GQA (self
and cross) and MLA attention layers, the FFN, the MoE FFN, the Mamba mixer
and the RWKV6 block, as pure functions over ``{name: tensor}`` subtrees.

Shapes follow the JAX package so weights carry across leaf by leaf:

* GQA weights keep head structure: ``w_q [H, NKV, G, DH]``.
* Activations ``q [B,S,N,G,D]``, ``k [B,Sk,N,D]``, ``v [B,Sk,N,Dv]`` (Dv =
  D but in MLA).
* ``attention_impl="cuda"`` (the default, serving) routes every attention
  core through the hand-written kernel (``repro_torch.kernels``);
  ``"chunked"`` is the JAX package's online-softmax attention in plain
  PyTorch (``attn_chunked``), under ``torch.utils.checkpoint``, what
  training runs; ``"naive"`` is plain tensor code with materialised scores,
  kept as the reference the kernel is held against inside the model.
* The WKV recurrence of ``rwkv6_layer`` is chosen by the same field, never
  by grad mode: ``"cuda"`` goes through ``kernels.ops.wkv6`` (the
  hand-written kernel for CUDA tensors, its plain version for CPU ones);
  any other runs the JAX layer's own chunk loop (``_wkv_chunk``) in plain
  PyTorch, which autograd follows.  The kernels have no backward and refuse
  an input that requires grad (``kernels/ops.py``).
* The Mamba mixer's selective scan (the ``mamba.ssm`` span) is chosen by
  the same field: ``"cuda"`` goes through ``kernels.ops.selective_scan``
  (the hand-written kernel for real CUDA tensors, its plain version for
  CPU, meta and fake ones); any other runs
  ``kernels.selective_scan.selective_scan_plain``, the JAX layer's plain
  scan (``lax.associative_scan``; the reference has no Pallas kernel
  there), which autograd follows.
* With ``repro_torch.obs`` tracing on, sub-layer parts record spans of
  their own: ``mamba.ssm`` (the selective scan, kernel or plain),
  ``moe.dispatch`` and ``moe.combine``; the scan counts its calls by path
  (``mamba.ssm_kernel``, ``mamba.ssm_plain``); and the routing counts its
  work and waste (``moe.picks`` and
  ``moe.experts_read`` on the host, ``moe.experts_used`` and ``moe.kept``
  on the device, with no sync).  With tracing off none of these runs.
* Every layer takes ``rules`` (``AxisRules``) and constrains its
  activations by logical axes at the JAX package's places: on DTensors
  (parameters placed on a ``DeviceMesh`` by ``parallel.sharding``) each
  ``constrain`` is a redistribute, on plain tensors nothing.  The MoE FFN
  has the JAX package's expert-parallel branch (all-to-all over the expert
  axis, ZeRO-3 gathers of the expert weights).

Where the layers meet DTensor's limits (each costs a gather on a real
mesh): the MoE routing runs replicated outside the expert-parallel branch
(no sharding rule for ``searchsorted``); the attention and wkv6 kernels
replicate the sequence, key and head dims (``kernels/ops.py``); and the
plain tensors the layers make (mask and position aranges, RoPE
frequencies, fp32 floors, the online softmax's zeros) are taken as
replicated (``models.common.on_mesh``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..obs import metrics
from ..obs.spans import enabled as tracing_enabled
from ..obs.spans import span, traced
from .common import (AxisRules, Initializer, RuntimeCfg, constrain,
                     copy_into, cumsum, dt, einsum, matmul, pad_end,
                     ring_append, write_span)

# logical axis names (mapped to mesh axes by parallel.sharding's rules), the
# JAX package's
EMB, HEADS, KV, QGRP, HDIM = "embed", "heads", "kv_heads", "q_grp", "head_dim"
FFN, VOCAB, EXP, LORA = "ffn", "vocab", "experts", "lora"
BATCH, SEQ, KVSEQ = "act_batch", "act_seq", "act_kv"


def cast(x: torch.Tensor, rt: RuntimeCfg) -> torch.Tensor:
    return x.to(dt(rt.compute_dtype))


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalises over the last dim in fp32 and casts back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last dim (halves ``[x1, x2]``, not
    interleaved); positions [B, S]; x [B, S, ..., D]."""
    d = x.shape[-1]
    half = d // 2
    freqs = (1.0 / theta) ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                     # [B,S,half]
    extra = x.dim() - 3                                            # head dims
    shape = tuple(ang.shape[:2]) + (1,) * extra + (half,)
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    parts = [x1 * cos - x2 * sin, x1 * sin + x2 * cos]
    if 2 * half != d:
        parts.append(x[..., 2 * half:])
    return torch.cat(parts, dim=-1).to(x.dtype)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (cap * torch.tanh(x / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """[sq, sk] bool: which keys the query row at ``q_offset + s`` sees."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attn_naive(q, k, v, *, causal: bool, window: Optional[int],
               softcap: Optional[float], q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,N,G,D], k [B,Sk,N,D], v [B,Sk,N,Dv] -> [B,Sq,N,G,Dv]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = einsum("bsngd,bknd->bngsk", q, k).float() * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return einsum("bngsk,bknd->bsngd", p, v)


def attn_chunked(q, k, v, *, causal: bool, window: Optional[int],
                 softcap: Optional[float], chunk: int = 1024,
                 q_offset: int = 0, q_block: bool = True) -> torch.Tensor:
    """Online-softmax (flash) attention in plain PyTorch, the JAX package's
    ``attn_chunked``: queries in blocks of ``chunk`` where that divides Sq
    (and Sq is longer), keys and values in chunks of ``chunk``.  q
    [B,Sq,N,G,D], k [B,Sk,N,D], v [B,Sk,N,Dv] -> [B,Sq,N,G,Dv]."""
    sq = q.shape[1]
    if q_block and sq > chunk and sq % chunk == 0:
        # the JAX package maps the blocks with traced offsets, so a block
        # never takes the naive shortcut of ``_attn_flash``
        outs = [_attn_flash(q[:, i:i + chunk], k, v, causal=causal,
                            window=window, softcap=softcap, chunk=chunk,
                            q_offset=q_offset + i, naive_ok=False)
                for i in range(0, sq, chunk)]
        return torch.cat(outs, dim=1)
    return _attn_flash(q, k, v, causal=causal, window=window,
                       softcap=softcap, chunk=chunk, q_offset=q_offset)


def _flash_chunk(m, l, acc, q, kci, vci, kpos, qpos, sk: int, causal: bool,
                 window: Optional[int], softcap: Optional[float],
                 scale: float) -> tuple:
    """One kv chunk of the online softmax: (m, l, acc) -> their update.
    Masked scores are -1e30 (not -inf), as in the JAX package."""
    s = einsum("bsngd,bknd->bngsk", q, kci).float() * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = kpos[None, :] < sk
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = s.masked_fill(~mask, -1e30)
    # amax and maximum split the gradient at a tie, as JAX's max does
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] \
        + einsum("bngsk,bknd->bngsd", p.to(q.dtype), vci)
    return m_new, l_new, acc_new


def _attn_flash(q, k, v, *, causal: bool, window: Optional[int],
                softcap: Optional[float], chunk: int, q_offset: int = 0,
                naive_ok: bool = True) -> torch.Tensor:
    """kv chunks of ``attn_chunked``, each under ``checkpoint``: the
    backward recomputes a chunk's probabilities instead of keeping
    O(Sq x chunk) fp32 residuals per chunk."""
    b, sq, n, g, d = q.shape
    sk = k.shape[1]
    if sk <= chunk and naive_ok:
        return attn_naive(q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=q_offset)
    nchunks = -(-sk // chunk)
    pad = nchunks * chunk - sk
    if pad:
        k, v = pad_end(k, 1, pad), pad_end(v, 1, pad)
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, n, g, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, g, sq, dv), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kpos = torch.arange(ci * chunk, (ci + 1) * chunk, device=q.device)
        m, l, acc = checkpoint(_flash_chunk, m, l, acc, q, k[:, sl], v[:, sl],
                               kpos, qpos, sk, causal, window, softcap, scale,
                               use_reentrant=False)
    out = acc / torch.maximum(l, l.new_full((), 1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)            # [B,Sq,N,G,Dv]


def attn_core(q, k, v, rt: RuntimeCfg, *, causal: bool, window=None,
              softcap=None, q_offset: int = 0) -> torch.Tensor:
    if rt.attention_impl == "cuda":
        # q, k, v go to the kernel in the compute dtype where it reads it
        # (bf16, fp32); any other is cast to fp32 and the output comes back
        # in q's dtype, as the Pallas kernel computes in fp32 and returns
        from ..kernels import ops as kops
        dtype = q.dtype
        if dtype not in kops.FLASH_INPUT_DTYPES:
            q, k, v = q.float(), k.float(), v.float()
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap,
                                    q_offset=q_offset).to(dtype)
    if rt.attention_impl == "chunked":
        # flash semantics: the backward recomputes from q/k/v instead of
        # keeping every chunk's probabilities
        fn = functools.partial(attn_chunked, causal=causal, window=window,
                               softcap=softcap, chunk=rt.attn_chunk,
                               q_offset=q_offset, q_block=rt.attn_q_block)
        return checkpoint(fn, q, k, v, use_reentrant=False)
    if rt.attention_impl == "naive":
        return attn_naive(q, k, v, causal=causal, window=window,
                          softcap=softcap, q_offset=q_offset)
    raise ValueError(f"attention_impl {rt.attention_impl!r}: "
                     "one of cuda | chunked | naive")


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def init_gqa(ini: Initializer, spec, prefix: str = "") -> dict:
    H, DHd = spec.d_model, spec.head_dim
    nkv = max(1, spec.n_kv_heads)
    g = max(1, spec.n_heads // nkv)
    p = {
        "ln": ini(prefix + "ln", (H,), (EMB,)),
        "w_q": ini(prefix + "w_q", (H, nkv, g, DHd), (EMB, KV, QGRP, HDIM)),
        "w_k": ini(prefix + "w_k", (H, nkv, DHd), (EMB, KV, HDIM)),
        "w_v": ini(prefix + "w_v", (H, nkv, DHd), (EMB, KV, HDIM)),
        "w_o": ini(prefix + "w_o", (nkv, g, DHd, H), (KV, QGRP, HDIM, EMB),
                   scale=1.0 / math.sqrt(H)),
    }
    if spec.qk_norm:
        p["qn"] = ini(prefix + "qn", (DHd,), (HDIM,))
        p["kn"] = ini(prefix + "kn", (DHd,), (HDIM,))
    return p


def _kv(p: dict, src: torch.Tensor, rt: RuntimeCfg) -> tuple:
    """k and v projected from ``src`` [B,T,H] (k normed where the layer has
    ``kn``)."""
    k = einsum("bth,hnd->btnd", src, cast(p["w_k"], rt))
    v = einsum("bth,hnd->btnd", src, cast(p["w_v"], rt))
    if p.get("kn") is not None:
        k = rms_norm(p["kn"], k)
    return k, v


def gqa_attention(p: dict, x: torch.Tensor, spec, rt: RuntimeCfg,
                  rules: Optional[AxisRules] = None, *, positions=None,
                  window: Optional[int] = None, causal: bool = True,
                  cross_kv: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None) -> tuple:
    """Attention with residual: x [B,S,H] -> (x + attn(x), new cache).

    Self-attention: ``cache`` (decode) is ``{"k", "v": [B, klen, NKV, DH],
    "pos": int}``.  Its k and v are **updated in place** and handed back in
    the new dict; ``pos`` is a Python int.  A sliding-window layer whose
    cache is no longer than the window keeps a ring: shift left, append,
    attend to the filled tail.  Writing past ``klen`` raises (JAX clamps the
    write instead).  ``causal=False`` with no cache is the encoder's.

    Cross-attention (whisper's decoder), as in the JAX package: with
    ``cross_kv`` [B,T,H] (the encoder's output), k and v come from it, q and
    k are not roped, no mask, and the new cache is ``{"k", "v"}``; with a
    cache that has no ``pos``, q attends to its k and v, unmasked, and the
    cache comes back unchanged."""
    h = rms_norm(p["ln"], x)
    h = constrain(h, rules, (BATCH, SEQ, EMB))
    q = einsum("bsh,hngd->bsngd", h, cast(p["w_q"], rt))
    if p.get("qn") is not None:
        q = rms_norm(p["qn"], q)
    q = constrain(q, rules, (BATCH, SEQ, KV, QGRP, HDIM))

    if cache is not None and "pos" not in cache:  # cached cross-attention
        new_cache = cache
        out5 = attn_core(q, cache["k"], cache["v"], rt, causal=False,
                         softcap=spec.attn_softcap)
    elif cross_kv is not None:                    # cross-attention, prefill
        k, v = _kv(p, cross_kv, rt)
        new_cache = {"k": k, "v": v}
        out5 = attn_core(q, k, v, rt, causal=False, window=window,
                         softcap=spec.attn_softcap)
    elif cache is not None:                     # decode against the cache
        k, v = _kv(p, h, rt)
        pos = int(cache["pos"])
        if positions is None:
            positions = torch.full(x.shape[:2], pos, dtype=torch.int32,
                                   device=x.device)
        k = rope(k, positions)
        q = rope(q, positions)
        ck, cv = cache["k"], cache["v"]
        klen, s_new = ck.shape[1], x.shape[1]
        new_cache = {"k": ck, "v": cv, "pos": pos + s_new}
        if window is not None and klen <= window:
            if s_new > klen:
                raise ValueError(f"{s_new} new tokens do not fit the "
                                 f"{klen}-entry window cache")
            wk, wv = ring_append(ck, k), ring_append(cv, v)
            filled = min(pos + s_new, klen)
            out5 = attn_core(q, wk[:, klen - filled:], wv[:, klen - filled:],
                             rt, causal=False, window=None,
                             softcap=spec.attn_softcap)
        else:
            if pos + s_new > klen:
                raise ValueError(
                    f"KV cache overflow: position {pos} + {s_new} new "
                    f"token(s) exceeds kv_len {klen}")
            write_span(ck, pos, k)
            write_span(cv, pos, v)
            out5 = attn_core(q, ck, cv, rt, causal=True, window=window,
                             softcap=spec.attn_softcap, q_offset=pos)
    else:
        k, v = _kv(p, h, rt)
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device) \
                .expand(x.shape[0], -1)
        q, k = rope(q, positions), rope(k, positions)
        new_cache = None
        out5 = attn_core(q, k, v, rt, causal=causal, window=window,
                         softcap=spec.attn_softcap)
    out = einsum("bsngd,ngdh->bsh", out5, cast(p["w_o"], rt))
    return x + constrain(out, rules, (BATCH, SEQ, EMB)), new_cache


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2)
# ---------------------------------------------------------------------------

def init_mla(ini: Initializer, spec, prefix: str = "") -> dict:
    m = spec.mla
    H, N = spec.d_model, spec.n_heads
    return {
        "ln": ini(prefix + "ln", (H,), (EMB,)),
        "w_dq": ini(prefix + "w_dq", (H, m.q_lora), (EMB, LORA)),
        "ln_q": ini(prefix + "ln_q", (m.q_lora,), (LORA,)),
        "w_uq_n": ini(prefix + "w_uq_n", (m.q_lora, N, m.nope_dim),
                      (LORA, HEADS, HDIM)),
        "w_uq_r": ini(prefix + "w_uq_r", (m.q_lora, N, m.rope_dim),
                      (LORA, HEADS, HDIM)),
        "w_dkv": ini(prefix + "w_dkv", (H, m.kv_lora), (EMB, LORA)),
        "ln_kv": ini(prefix + "ln_kv", (m.kv_lora,), (LORA,)),
        "w_kr": ini(prefix + "w_kr", (H, m.rope_dim), (EMB, HDIM)),
        "w_uk": ini(prefix + "w_uk", (m.kv_lora, N, m.nope_dim),
                    (LORA, HEADS, HDIM)),
        "w_uv": ini(prefix + "w_uv", (m.kv_lora, N, m.v_dim),
                    (LORA, HEADS, HDIM)),
        "w_o": ini(prefix + "w_o", (N, m.v_dim, H), (HEADS, HDIM, EMB),
                   scale=1.0 / math.sqrt(H)),
    }


def mla_attention(p: dict, x: torch.Tensor, spec, rt: RuntimeCfg,
                  rules: Optional[AxisRules] = None, *, positions=None,
                  cache: Optional[dict] = None) -> tuple:
    """Multi-head latent attention with residual: x [B,S,H] -> (x + attn(x),
    new cache).

    ``cache`` (decode) is ``{"ckv": [B, kv_len, kv_lora], "kr": [B, kv_len,
    rope_dim], "pos": int}``; ckv and kr are **updated in place** and handed
    back in the new dict.  Writing past kv_len raises (JAX clamps the write
    instead).

    Two paths compute the same mathematics.  The JAX package's (*recompute*)
    makes k's nope part and v of all N heads from the whole ckv cache, with
    the rope key ``kr`` shared by all heads, and attends with q/k of head dim
    nope + rope and v of v_dim (the kernel's Dv < D instance), scaled by
    1/sqrt(nope + rope).  The *absorbed* one (``_mla_absorbed``) folds W_uk
    into the query and W_uv into the output, and attends with N query heads
    over one shared key ``[ckv | kr]`` and one shared value ``ckv``: what
    the cache holds, read in place.  A decode step of one token takes the
    absorbed path where ``rt.attention_impl == "cuda"``, the tensors are
    plain CPU or CUDA ones and nothing requires grad under grad mode, and
    then ckv and kr have to be the column views of one latent buffer
    (``lm.init_cache``), or the step raises; every other call (another
    impl, meta or fake tensors, DTensors, training, prefill, a step of
    several tokens) recomputes.  With tracing
    on, each decode call counts its path (``mla.decode_absorbed`` /
    ``mla.decode_recompute``), the absorbed one the latent rows it reads
    (``mla.latent_rows``, batch x keys) and records the spans ``mla.absorb``
    and ``mla.attend``."""
    m = spec.mla
    h = rms_norm(p["ln"], x)
    h = constrain(h, rules, (BATCH, SEQ, EMB))
    cq = rms_norm(p["ln_q"], matmul(h, cast(p["w_dq"], rt)))
    qn = einsum("bsr,rnd->bsnd", cq, cast(p["w_uq_n"], rt))
    qr = einsum("bsr,rnd->bsnd", cq, cast(p["w_uq_r"], rt))
    ckv_new = rms_norm(p["ln_kv"], matmul(h, cast(p["w_dkv"], rt)))
    kr_new = matmul(h, cast(p["w_kr"], rt))                   # [B,S,rope]
    if cache is not None:
        pos = int(cache["pos"])
        s_new = x.shape[1]
        if positions is None:
            positions = torch.full(x.shape[:2], pos, dtype=torch.int32,
                                   device=x.device)
        qr = rope(qr, positions)
        kr_new = rope(kr_new[:, :, None], positions)[:, :, 0]
        ckv, kr = cache["ckv"], cache["kr"]
        if pos + s_new > ckv.shape[1]:
            raise ValueError(
                f"KV cache overflow: position {pos} + {s_new} new token(s) "
                f"exceeds kv_len {ckv.shape[1]}")
        write_span(ckv, pos, ckv_new)
        write_span(kr, pos, kr_new)
        new_cache = {"ckv": ckv, "kr": kr, "pos": pos + s_new}
        q_offset = pos
        absorbed = s_new == 1 and _absorbable(rt, x, p)
        if tracing_enabled():
            metrics.counter("mla.decode_absorbed" if absorbed
                            else "mla.decode_recompute").inc()
        if absorbed:
            out = _mla_absorbed(p, qn, qr, _latent_buffer(ckv, kr), m, rt,
                                pos)
            return x + constrain(out, rules, (BATCH, SEQ, EMB)), new_cache
    else:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device) \
                .expand(x.shape[0], -1)
        qr = rope(qr, positions)
        kr_new = rope(kr_new[:, :, None], positions)[:, :, 0]
        ckv, kr = ckv_new, kr_new
        new_cache = None
        q_offset = 0

    kn = einsum("btr,rnd->btnd", ckv, cast(p["w_uk"], rt))
    vv = einsum("btr,rnd->btnd", ckv, cast(p["w_uv"], rt))
    n = kn.shape[2]
    qq = torch.cat([qn, qr], dim=-1)[:, :, :, None, :]        # [B,S,N,1,D]
    kk = torch.cat([kn, kr[:, :, None].expand(-1, -1, n, m.rope_dim)],
                   dim=-1)                                    # [B,T,N,D]
    out5 = attn_core(qq, kk, vv, rt, causal=True, q_offset=q_offset)
    out = einsum("bsnd,ndh->bsh", out5[:, :, :, 0], cast(p["w_o"], rt))
    return x + constrain(out, rules, (BATCH, SEQ, EMB)), new_cache


def _absorbable(rt: RuntimeCfg, x: torch.Tensor, p: dict) -> bool:
    """Whether an MLA decode step may take the absorbed path: the kernel's
    impl, plain CPU or CUDA tensors (no DTensor, no meta or fake tensor),
    and no input that autograd would have to follow."""
    if rt.attention_impl != "cuda" or type(x) is not torch.Tensor \
            or x.device.type not in ("cpu", "cuda"):
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.values())))


def _latent_buffer(ckv: torch.Tensor, kr: torch.Tensor) -> torch.Tensor:
    """``[ckv | kr]`` as one ``[B, T, 1, kv_lora + rope]`` view of the latent
    buffer whose column views ckv and kr are (``lm.init_cache``); raises
    for any other pair of tensors."""
    r, w = ckv.shape[-1], ckv.shape[-1] + kr.shape[-1]
    if type(ckv) is not torch.Tensor or ckv.dim() != 3 \
            or ckv.stride() != kr.stride() or ckv.stride(-1) != 1 \
            or ckv.stride(1) < w or ckv.shape[:2] != kr.shape[:2] \
            or kr.data_ptr() != ckv.data_ptr() + r * ckv.element_size():
        raise ValueError(
            "the absorbed MLA decode reads ckv and kr as the column views "
            "of one [.., kv_len, kv_lora + rope] latent buffer "
            "(lm.init_cache); got ckv of strides "
            f"{tuple(ckv.stride())} and kr of strides {tuple(kr.stride())} "
            "apart")
    b, t = ckv.shape[:2]
    return ckv.as_strided((b, t, 1, w), (ckv.stride(0), ckv.stride(1), w, 1))


def _mla_absorbed(p: dict, qn, qr, latent, m, rt: RuntimeCfg,
                  pos: int) -> torch.Tensor:
    """The absorbed decode step: ``q_lat = q_nope W_uk`` (fp32, one
    rounding to the compute dtype, with ``[q_lat | q_rope]`` scaled by
    sqrt((kv_lora + rope) / (nope + rope)) so that the attention's
    1/sqrt(kv_lora + rope) gives MLA's 1/sqrt(nope + rope)), attention of
    the N heads over the latent rows 0..pos (key: the whole row, value: its
    first kv_lora columns), then ``W_uv`` and ``W_o`` -> [B, 1, H].  The
    call goes through ``attn_core`` to ``kernels.ops.flash_attention``: on
    the card its MLA decode instance (or, for latent rows of at most
    ``MAX_HEAD_DIM`` columns, as in the smoke specs, its other kernels), on
    the CPU its plain version.  One case on the card goes to
    ``flash_attention_plain`` instead: float32 at the instance's widths
    (the float32 witness of ``calibrate.py --served-dtype float32``), since
    the instance is built for bf16 alone; any other shape it does not take
    raises in the launch."""
    from ..kernels import flash_attention as kfa
    b = qn.shape[0]
    width = m.kv_lora + m.rope_dim
    fold = math.sqrt(width / (m.nope_dim + m.rope_dim))
    with span("mla.absorb"):
        q_lat = torch.einsum("bsnd,rnd->bsnr", qn.float(),
                             p["w_uk"].float())
        q = (torch.cat([q_lat, qr.float()], dim=-1) * fold) \
            .to(latent.dtype)[:, :, None]                 # [B,1,1,N,width]
    with span("mla.attend"):
        k, v = latent[:, :pos + 1], latent[:, :pos + 1, :, :m.kv_lora]
        if q.is_cuda and q.dtype == torch.float32 \
                and q.shape[-1] > kfa.MAX_HEAD_DIM:
            # the float32 witness: the MLA decode instance is bf16 alone
            o_lat = kfa.flash_attention_plain(q, k, v, causal=True,
                                              q_offset=pos)
        else:
            o_lat = attn_core(q, k, v, rt, causal=True, q_offset=pos)
    if tracing_enabled():
        metrics.counter("mla.latent_rows").inc(b * (pos + 1))
    with span("mla.absorb"):
        o = einsum("bsnr,rnd->bsnd", o_lat[:, :, 0], cast(p["w_uv"], rt))
        return einsum("bsnd,ndh->bsh", o, cast(p["w_o"], rt))


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def init_ffn(ini: Initializer, spec, width: Optional[int] = None,
             prefix: str = "", gated: Optional[bool] = None) -> dict:
    H = spec.d_model
    f = width or spec.d_ff
    gated = spec.gated_ffn if gated is None else gated
    p = {
        "ln": ini(prefix + "ln_f", (H,), (EMB,)),
        "w_up": ini(prefix + "w_up", (H, f), (EMB, FFN)),
        "w_down": ini(prefix + "w_down", (f, H), (FFN, EMB),
                      scale=1.0 / math.sqrt(f)),
    }
    if gated:
        p["w_gate"] = ini(prefix + "w_gate", (H, f), (EMB, FFN))
    return p


def ffn(p: dict, x: torch.Tensor, spec, rt: RuntimeCfg,
        rules: Optional[AxisRules] = None) -> torch.Tensor:
    h = rms_norm(p["ln"], x)
    h = constrain(h, rules, (BATCH, SEQ, EMB))
    up = matmul(h, cast(p["w_up"], rt))
    if "w_gate" in p:
        act = F.silu(matmul(h, cast(p["w_gate"], rt))) * up
    else:
        act = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default form
    act = constrain(act, rules, (BATCH, SEQ, FFN))
    down = matmul(act, cast(p["w_down"], rt))
    return x + constrain(down, rules, (BATCH, SEQ, EMB))


# ---------------------------------------------------------------------------
# MoE FFN (deepseek-moe, deepseek-v2): sort-based top-k with static capacity
# ---------------------------------------------------------------------------

def init_moe(ini: Initializer, spec, prefix: str = "") -> dict:
    """The router ``w_router`` is drawn in fp32 at any parameter dtype, as in
    the JAX package, so routing does not depend on it."""
    H = spec.d_model
    mo = spec.moe
    p = {
        "ln": ini(prefix + "ln_moe", (H,), (EMB,)),
        "w_router": ini(prefix + "w_router", (H, mo.n_experts),
                        (EMB, "router"), dtype=torch.float32),
        "w_egate": ini(prefix + "w_egate", (mo.n_experts, H, mo.d_expert),
                       (EXP, EMB, FFN)),
        "w_eup": ini(prefix + "w_eup", (mo.n_experts, H, mo.d_expert),
                     (EXP, EMB, FFN)),
        "w_edown": ini(prefix + "w_edown", (mo.n_experts, mo.d_expert, H),
                       (EXP, FFN, EMB), scale=1.0 / math.sqrt(mo.d_expert)),
    }
    if mo.n_shared:
        sw = mo.n_shared * mo.d_expert
        p["shared"] = init_ffn(ini, spec, width=sw, prefix=prefix + "sh_",
                               gated=True)
    return p


def top_k_lowest_first(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the ``k`` largest entries of the last dim in
    descending order, an equal value with the lower index first: the order
    ``jax.lax.top_k`` returns (``torch.topk`` promises none on a tie)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@traced("moe.dispatch")
def moe_dispatch(h: torch.Tensor, wr: torch.Tensor, *, E: int, Kk: int,
                 capacity_factor: float) -> dict:
    """Routing and dispatch of tokens ``h [b, s, H]`` over ``E`` experts.

    Each token picks its ``Kk`` most probable experts (fp32 router softmax,
    gates renormalised over the K and cast to h's dtype).  The T·K choices
    are sorted by expert with a **stable** sort, so choices of one expert
    keep token order; the one of rank r in its expert's run goes to slot r of
    that expert, and only ranks below the capacity C = ceil(T·K/E·cf) are
    kept: the others are dropped, as in the JAX package (at decode C is
    small: 8 tokens of top 6 over 64 experts give C = 1).  Each kept slot is
    written once, so the dispatch is a plain indexed copy (no atomics), and
    nothing in it waits on the device.

    Returns ``dispatched [E, C, H]`` and, for the combine, the sorted
    entries' expert ``se``, token ``st``, ``rank``, ``keep`` and gate, and
    C."""
    b, s, H = h.shape
    logits = einsum("bsh,he->bse", h.float(), wr)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lowest_first(probs, Kk)
    # maximum, not clamp: at a tie it splits the gradient as JAX does (the
    # floor made on the device: a scalar from the host would wait for it)
    gsum = gates.sum(-1, keepdim=True)
    gates = (gates / torch.maximum(gsum, gsum.new_full((), 1e-9))).to(h.dtype)
    T = b * s
    C = max(1, int(math.ceil(T * Kk / E * capacity_factor)))
    flat_idx = idx.reshape(T * Kk)
    flat_tok = torch.arange(T, device=h.device).repeat_interleave(Kk)
    order = torch.argsort(flat_idx, stable=True)
    se, st = flat_idx[order], flat_tok[order]
    # the first sorted position of each entry's expert: its rank is the
    # distance to it (no bincount, no boolean mask: nothing here waits on
    # the device)
    rank = torch.arange(T * Kk, device=h.device) - torch.searchsorted(se, se)
    keep = rank < C
    if tracing_enabled():
        _count_routing(E, T * Kk, rank, keep)
    # row se * C + rank of an [E * C + 1, H] buffer; every dropped entry
    # goes to the last row, which is cut off
    slot = torch.where(keep, se * C + rank, torch.full_like(se, E * C))
    buf = torch.zeros((E * C + 1, H), dtype=h.dtype, device=h.device)
    buf[slot] = h.reshape(T, H)[st]
    return {"dispatched": buf[:E * C].view(E, C, H), "se": se, "st": st,
            "rank": rank, "keep": keep, "gate": gates.reshape(T * Kk)[order],
            "C": C}


def _count_routing(E: int, picks: int, rank, keep) -> None:
    """The routing's work and waste, while tracing is on: picks (T·K) and
    experts read (E: the expert products read every expert) on the host;
    on the device, in one reduction with no sync, the experts that kept a
    pick (the entries of rank 0) and the picks kept (the rest capacity
    dropped)."""
    metrics.counter("moe.picks").inc(picks)
    metrics.counter("moe.experts_read").inc(E)
    metrics.device_counter("moe.experts_used", "moe.kept").add(
        torch.stack((rank == 0, keep)).sum(1))


@traced("moe.combine")
def moe_combine(eo: torch.Tensor, route: dict, T: int, Kk: int) -> torch.Tensor:
    """Expert outputs ``eo [E, C, H]`` back to tokens: [T, H].

    The JAX package adds each kept entry's gate-weighted output into the
    token's row in sorted order, i.e. a token's experts in ascending expert
    order, rounding to the compute dtype at each add.  Here each token's K
    entries are gathered into [T, K, H] in that order (a dropped entry is 0)
    and summed one after the other: the same order and roundings on the CPU
    and the card, with no atomics."""
    se, st, rank, keep = route["se"], route["st"], route["rank"], route["keep"]
    contrib = eo[se, torch.clamp(rank, max=route["C"] - 1)] \
        * route["gate"][:, None]
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    # sorted entry i is token st[i]'s j-th choice in expert order, where j
    # counts the token's entries before i: a stable sort by token keeps the
    # expert order inside each token
    by_token = torch.argsort(st, stable=True)
    per_token = contrib[by_token].reshape(T, Kk, -1)
    out = per_token[:, 0]
    for j in range(1, Kk):
        out = out + per_token[:, j]
    return out


def _experts(dispatched: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The experts' gated FFN over their slots: [E, C, H] -> [E, C, H]."""
    ea = F.silu(torch.bmm(dispatched, wg)) * torch.bmm(dispatched, wu)
    return torch.bmm(ea, wd)


def _route_and_compute(h, wr, wg, wu, wd, *, E: int, Kk: int,
                       capacity_factor: float, ep_group=None, ep: int = 1,
                       gather_groups: tuple = ()) -> torch.Tensor:
    """Routing, dispatch, the expert products and the combine of the tokens
    ``h [b, s, H]`` this rank holds: plain tensors, the body the JAX package
    runs under ``shard_map``.  With ``ep_group`` the expert weights are this
    rank's ``E / ep`` experts and an all-to-all pair over the group carries
    every expert's slots to its owner and the outputs back (the EP pattern
    the STG matcher predicts, Table IV).  ``gather_groups`` (minor mesh axis
    first) all-gather the weights' dim 1 just in time: ZeRO-3 inside the EP
    block.  Both collectives are differentiable.  The capacity comes from
    the local token count."""
    from torch.distributed import _functional_collectives as fc
    b, s, H = h.shape
    for g in gather_groups:
        wg, wu, wd = (fc.all_gather_tensor_autograd(w, 1, g)
                      for w in (wg, wu, wd))
    route = moe_dispatch(h, wr, E=E, Kk=Kk, capacity_factor=capacity_factor)
    dispatched = route["dispatched"]
    C = route["C"]
    if ep_group is not None:
        # expert group j's slots go to the rank at ep-coordinate j, and come
        # back from it in the same order
        e_loc = E // ep
        recv = fc.all_to_all_single_autograd(
            dispatched.reshape(ep, e_loc * C * H).contiguous(), None, None,
            ep_group)
        dispatched = recv.reshape(ep, e_loc, C, H).transpose(0, 1) \
            .reshape(e_loc, ep * C, H)
    eo = _experts(dispatched, wg, wu, wd)
    if ep_group is not None:
        send = eo.reshape(e_loc, ep, C, H).transpose(0, 1).contiguous()
        eo = fc.all_to_all_single_autograd(
            send.reshape(ep, e_loc * C * H), None, None, ep_group) \
            .reshape(E, C, H)
    return moe_combine(eo, route, b * s, Kk).reshape(b, s, H)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``c``."""

    @staticmethod
    def forward(ctx, x, c: float):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _local_block(fn, mesh, args: tuple, in_specs: tuple, out_spec: tuple):
    """``fn`` over this rank's shards of the DTensors ``args``, laid out by
    ``in_specs``, its result a DTensor laid out by ``out_spec``: the JAX
    package's ``shard_map`` with ``check_vma=False``, gradients included.
    A mesh axis an output spec leaves out claims a replicated result, so
    the output's gradient is divided by its size on each rank, and an input
    spec's left-out axes sum their ranks' gradients: shard_map's
    transpose."""
    from torch.distributed.tensor import DTensor, Partial
    from ..parallel.sharding import spec_placements
    from .common import settle, whole_on_single

    def free(spec):
        return [(i, n) for i, n in enumerate(mesh.mesh_dim_names)
                if n not in {a for e in spec if e is not None
                             for a in (e if isinstance(e, tuple) else (e,))}]
    locs = []
    for a, spec in zip(args, in_specs):
        placements = spec_placements(spec, mesh)
        grad_pl = list(placements)
        for i, _ in free(spec):
            grad_pl[i] = Partial()
        a = settle(a, placements)
        for i in range(mesh.ndim):
            if mesh.size(i) == 1:
                grad_pl[i] = a.placements[i]
        locs.append(a.to_local(grad_placements=grad_pl))
    out = fn(*locs)
    rep = math.prod(mesh.size(i) for i, _ in free(out_spec))
    if rep > 1:
        out = _ScaleGrad.apply(out, 1.0 / rep)
    return DTensor.from_local(
        out, mesh, whole_on_single(spec_placements(out_spec, mesh), mesh),
        run_check=False)


def moe_ffn(p: dict, x: torch.Tensor, spec, rt: RuntimeCfg,
            rules: Optional[AxisRules] = None, *,
            capacity_factor: float = 0.0) -> torch.Tensor:
    """Sort-based top-k MoE with static expert capacity, plus the shared
    experts, with residual: x [B,S,H] -> x'.  The expert products are
    batched matrix products (the JAX package leaves them to XLA as einsums).

    On a mesh (DTensor activations), as in the JAX package: where
    ``rules.mesh`` is set, its expert axis (``rules["experts"]``) has more
    than one rank and divides E, the block runs on local shards (the JAX
    package's ``shard_map``): tokens stay on their data shard (and split
    their sequence over the expert axis where it divides and S > 1; at
    decode every expert-axis peer routes the same tokens), the experts are
    sharded over the expert axis, ZeRO-3 over the data axes where H
    divides, and dispatch and combine are all-to-alls.  Otherwise the
    routing runs on every rank over all tokens, replicated: DTensor has no
    sharding rule for ``searchsorted``, so the tokens and the expert
    weights are gathered there."""
    from torch.distributed.tensor import DTensor
    mo = spec.moe
    capacity_factor = capacity_factor or rt.moe_capacity
    b, s, H = x.shape
    h = rms_norm(p["ln"], x)
    h = constrain(h, rules, (BATCH, SEQ, EMB))
    wr = p["w_router"]
    wg, wu, wd = (cast(p[k], rt) for k in ("w_egate", "w_eup", "w_edown"))
    body = functools.partial(_route_and_compute, E=mo.n_experts, Kk=mo.top_k,
                             capacity_factor=capacity_factor)
    mesh = getattr(rules, "mesh", None) if rules is not None else None
    ep_axis = rules.rules.get("experts") if rules is not None else None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None \
        else {}
    shared = [cast(p["shared"][k], rt) for k in ("w_gate", "w_up", "w_down")] \
        if "shared" in p else []

    def with_shared(h, *w):
        """The routed experts, then the shared ones added (plain tensors)."""
        out = body(h, *w[:4])
        if w[4:]:
            wsg, wsu, wsd = w[4:]
            out = out + matmul(F.silu(matmul(h, wsg)) * matmul(h, wsu), wsd)
        return out
    if not isinstance(h, DTensor):
        out = with_shared(h, wr, wg, wu, wd, *shared)
    elif ep_axis in sizes and mo.n_experts % sizes[ep_axis] == 0 \
            and sizes[ep_axis] > 1:
        da = rules.rules.get("act_batch") or ()
        da = tuple(a for a in (da if isinstance(da, (tuple, list)) else (da,))
                   if a in sizes)
        deg = math.prod(sizes[a] for a in da)
        ep = sizes[ep_axis]
        da_e = da if len(da) != 1 else da[0]
        if da and b % deg == 0 and s % ep == 0 and s > 1:
            bspec = (da_e, ep_axis)
        elif da and b % deg == 0:
            bspec = (da_e,)
        else:
            bspec = ()
        gather = da if da and all(w.shape[1] % deg == 0 for w in (wg, wu)) \
            else ()
        wspec = (ep_axis, da_e if gather else None)
        out = _local_block(
            functools.partial(body, ep_group=mesh.get_group(ep_axis), ep=ep,
                              gather_groups=tuple(mesh.get_group(a)
                                                  for a in reversed(gather))),
            mesh, (h, wr, wg, wu, wd), (bspec, (), wspec, wspec, wspec),
            bspec)
        if shared:                     # outside shard_map, as in JAX
            wsg, wsu, wsd = shared
            out = out + matmul(F.silu(matmul(h, wsg)) * matmul(h, wsu), wsd)
    else:
        # the shared experts run in the same replicated block, so that h's
        # gradient is summed in the order of the plain path
        args = (h, wr, wg, wu, wd, *shared)
        out = _local_block(with_shared, h.device_mesh, args,
                           ((),) * len(args), ())
    return x + constrain(out, rules, (BATCH, SEQ, EMB))


# ---------------------------------------------------------------------------
# Mamba (selective SSM): the scan (kernels/selective_scan.py) with an O(1)
# carried state
# ---------------------------------------------------------------------------

def init_mamba(ini: Initializer, spec, prefix: str = "") -> dict:
    """``A_log`` is drawn in fp32 at any parameter dtype, as in the JAX
    package."""
    H = spec.d_model
    ss = spec.ssm
    din = ss.expand * H
    dtr = ss.dt_rank or H // 16
    return {
        "ln": ini(prefix + "ln_ssm", (H,), (EMB,)),
        "w_in": ini(prefix + "w_in", (H, 2 * din), (EMB, FFN)),
        "conv": ini(prefix + "conv", (4, din), ("conv", FFN), scale=0.5),
        "w_xdb": ini(prefix + "w_xdb", (din, dtr + 2 * ss.d_state),
                     (FFN, LORA)),
        "w_dt": ini(prefix + "w_dt", (dtr, din), (LORA, FFN)),
        "A_log": ini(prefix + "A_log", (din, ss.d_state), (FFN, "state"),
                     scale=1.0, dtype=torch.float32),
        "D": ini(prefix + "D", (din,), (FFN,)),
        "w_out": ini(prefix + "w_out", (din, H), (FFN, EMB),
                     scale=1.0 / math.sqrt(din)),
    }


def _causal_conv(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv of ``xpad`` [B, 3 + S, Din] (three earlier
    inputs, then S new) with taps ``w`` [4, Din]: [B, S, Din], the four
    products summed in the JAX package's order in the compute dtype."""
    s = xpad.shape[1] - 3
    out = xpad[:, 0:s] * w[0]
    for i in range(1, 4):
        out = out + xpad[:, i:i + s] * w[i]
    return out


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    threshold (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_layer(p: dict, x: torch.Tensor, spec, rt: RuntimeCfg,
                rules: Optional[AxisRules] = None, *,
                cache: Optional[dict] = None) -> tuple:
    """Selective-SSM mixer with residual: x [B,S,H] -> (x', new cache).

    ``cache`` (decode) is ``{"conv": [B, 3, Din] compute dtype, "ssm": [B,
    Din, P] fp32}``: the last three conv inputs and the scan state.  Its
    tensors are **updated in place** and handed back in the new dict.  The
    causal conv sums its four taps in the JAX package's order in the compute
    dtype; dt, dA, dBx and the state are fp32, y is cast back to x's
    dtype.  ``rt.attention_impl == "cuda"`` runs the selective scan through
    its kernel's entry (the kernel for real CUDA tensors; forward only), any
    other value through ``selective_scan_plain``, which autograd follows."""
    ss = spec.ssm
    b, s, H = x.shape
    din = ss.expand * H
    dtr = ss.dt_rank or H // 16
    h = rms_norm(p["ln"], x)
    h = constrain(h, rules, (BATCH, SEQ, EMB))
    xz = matmul(h, cast(p["w_in"], rt))
    xs, z = xz[..., :din], xz[..., din:]

    prev = cache["conv"] if cache is not None else xs.new_zeros((b, 3, din))
    xpad = torch.cat([prev, xs], dim=1)
    xc = F.silu(_causal_conv(xpad, cast(p["conv"], rt)))

    xdb = matmul(xc, cast(p["w_xdb"], rt))
    dt0, Bt, Ct = (xdb[..., :dtr], xdb[..., dtr:dtr + ss.d_state],
                   xdb[..., dtr + ss.d_state:])
    dtt = _softplus(matmul(dt0, cast(p["w_dt"], rt)).float())       # [B,S,Din]
    with span("mamba.ssm"):
        from ..kernels import selective_scan as kss
        args = (dtt, xc, Bt, Ct, p["A_log"],
                cache["ssm"] if cache is not None else None)
        before = kss.launches
        if rt.attention_impl == "cuda":
            from ..kernels import ops as kops
            y, h_last = kops.selective_scan(*args, state=cache is not None)
        else:
            y, h_last = kss.selective_scan_plain(*args)
        if tracing_enabled():
            metrics.counter("mamba.ssm_kernel" if kss.launches > before
                            else "mamba.ssm_plain").inc()
    y = y + xc * cast(p["D"], rt)
    y = y * F.silu(z)
    out = matmul(y, cast(p["w_out"], rt))
    new_cache = None
    if cache is not None:
        copy_into(cache["conv"], xpad[:, -3:])
        copy_into(cache["ssm"], h_last)
        new_cache = {"conv": cache["conv"], "ssm": cache["ssm"]}
    return x + constrain(out, rules, (BATCH, SEQ, EMB)), new_cache


# ---------------------------------------------------------------------------
# RWKV6 (Finch): chunked linear attention with data-dependent decay
# ---------------------------------------------------------------------------

def init_rwkv6(ini: Initializer, spec, prefix: str = "") -> dict:
    H = spec.d_model
    nh, dh = spec.n_heads, spec.head_dim
    rk = spec.rwkv_decay_rank
    p = {"ln": ini(prefix + "ln_tm", (H,), (EMB,)),
         "u": ini(prefix + "u", (nh, dh), (HEADS, HDIM), scale=1.0)}
    for nm in ("r", "k", "v", "g"):
        p[f"mu_{nm}"] = ini(prefix + f"mu_{nm}", (H,), (EMB,), scale=1.0)
        p[f"w_{nm}"] = ini(prefix + f"w_{nm}", (H, nh, dh), (EMB, HEADS, HDIM))
    p["mu_w"] = ini(prefix + "mu_w", (H,), (EMB,), scale=1.0)
    p["w_dec1"] = ini(prefix + "w_dec1", (H, rk), (EMB, LORA))
    p["w_dec2"] = ini(prefix + "w_dec2", (rk, nh, dh), (LORA, HEADS, HDIM))
    p["gn"] = ini(prefix + "gn", (dh,), (HDIM,))
    p["w_tmo"] = ini(prefix + "w_tmo", (nh, dh, H), (HEADS, HDIM, EMB),
                     scale=1.0 / math.sqrt(H))
    # channel mix
    p["ln_cm"] = ini(prefix + "ln_cm", (H,), (EMB,))
    p["mu_ck"] = ini(prefix + "mu_ck", (H,), (EMB,), scale=1.0)
    p["mu_cr"] = ini(prefix + "mu_cr", (H,), (EMB,), scale=1.0)
    p["w_ck"] = ini(prefix + "w_ck", (H, spec.d_ff), (EMB, FFN))
    p["w_cv"] = ini(prefix + "w_cv", (spec.d_ff, H), (FFN, EMB),
                    scale=1.0 / math.sqrt(spec.d_ff))
    p["w_cr"] = ini(prefix + "w_cr", (H, H), (EMB, EMB))
    return p


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} stream ([B,S,H]); ``prev`` is the carried last token (zeros
    before the first)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


WKV_CHUNK = 32


def _wkv_chunk(r, k, v, w, u, state) -> tuple:
    """One chunk of RWKV6, the JAX layer's own: r/k/v/w [B,C,N,D] fp32 (w =
    decay in (0,1)), u [N,D], state [B,N,D,D] -> (out [B,C,N,D], new state).

    The intra-chunk term factorises the pairwise decay
    ``exp(sum_{j<l<=t} log w_l)`` as ``exp(cum_t) exp(-cum_j)``; to keep the
    positive exponent finite the per-step log-decay is floored at ``-80/C``
    for the factorisation only.  The state's decay uses the true value."""
    C = r.shape[1]
    lw = torch.log(torch.maximum(w, w.new_full((), 1e-30)))  # [B,C,N,D], true
    cum = cumsum(lw, 1)                                    # inclusive
    cum_excl = cum - lw
    # inter-chunk: r_t . (decay-to-t o state), exponent <= 0
    inter = einsum("bcnd,bnde->bcne", r * torch.exp(cum_excl), state)
    # intra-chunk: s_tj = sum_d r_td k_jd exp(cum_excl_t - cum_j), j < t
    lwc = torch.maximum(lw, lw.new_full((), -80.0 / C))
    cumc = cumsum(lwc, 1)
    rt_ = r * torch.exp(cumc - lwc)
    kt = k * torch.exp(-cumc)
    s = einsum("bcnd,bjnd->bncj", rt_, kt)
    cix = torch.arange(C, device=r.device)
    s = s.masked_fill(cix[:, None] <= cix[None, :], 0.0)
    intra = einsum("bncj,bjne->bcne", s, v)
    # current-token bonus
    bonus = einsum("bcnd,bcnd,bcne->bcne", r, u[None, None] * k, v)
    out = inter + intra + bonus
    # state update: S' = decay_total o S + sum_j (k_j decay_{j->end})^T v_j
    total = cum[:, -1]                                     # [B,N,D]
    kdec = k * torch.exp(total[:, None] - cum)
    upd = einsum("bjnd,bjne->bnde", kdec, v)
    return out, state * torch.exp(total)[..., None] + upd


def rwkv6_layer(p: dict, x: torch.Tensor, spec, rt: RuntimeCfg,
                rules: Optional[AxisRules] = None, *,
                cache: Optional[dict] = None) -> tuple:
    """Time mix + channel mix with residuals: x [B,S,H] -> (x', new cache).

    ``cache`` (decode) is ``{"wkv": [B,N,D,D] fp32, "shift_tm", "shift_cm":
    [B,H]}``.  Its tensors are **updated in place** (the kernel writes the new
    state over the old one) and handed back in the new dict.  The chunk rule
    is the JAX layer's: ``min(32, S)``, and one chunk of S when that does
    not divide S; the chunk is part of the result (``kernels/rwkv6_scan.py``).

    ``rt.attention_impl == "cuda"`` runs the recurrence through the wkv6
    kernel (r, k, v in the compute dtype; forward only); any other value
    runs the JAX layer's chunk loop (``_wkv_chunk``, r, k, v in fp32), which
    autograd follows."""
    b, s, _ = x.shape
    nh, dh = spec.n_heads, spec.head_dim
    h = rms_norm(p["ln"], x)
    h = constrain(h, rules, (BATCH, SEQ, EMB))
    shifted = _token_shift(h, cache["shift_tm"] if cache is not None else None)

    def mix(nm):
        return h + (shifted - h) * cast(p[f"mu_{nm}"], rt)

    def heads(nm):
        return einsum("bsh,hnd->bsnd", mix(nm), cast(p[f"w_{nm}"], rt))

    r, k, v = (heads(nm) for nm in ("r", "k", "v"))
    g = heads("g")
    d1 = matmul(mix("w"), cast(p["w_dec1"], rt))
    dec = einsum("bsr,rnd->bsnd", d1, cast(p["w_dec2"], rt)).float()
    w = torch.exp(-torch.exp(dec))                       # (0,1) decay

    cs = min(WKV_CHUNK, s)
    if s % cs:
        cs = s
    u = p["u"].float()
    if cache is not None:
        state0 = cache["wkv"]
    else:
        state0 = torch.zeros((b, nh, dh, dh), dtype=torch.float32,
                             device=x.device)
    if rt.attention_impl == "cuda":
        # r, k, v in the compute dtype: wkv6 reads bf16 and fp32 as they
        # are and casts any other to fp32
        from ..kernels import ops as kops
        out, _ = kops.wkv6(r, k, v, w, u, state0, chunk=cs,
                           state_out=state0 if cache is not None else None)
    else:
        state, outs = state0, []
        for c0 in range(0, s, cs):
            sl = slice(c0, c0 + cs)
            o, state = _wkv_chunk(r[:, sl].float(), k[:, sl].float(),
                                  v[:, sl].float(), w[:, sl], u, state)
            outs.append(o)
        out = torch.cat(outs, dim=1)
        if cache is not None:
            copy_into(cache["wkv"], state)
    out = rms_norm(p["gn"], out.to(x.dtype))             # per-head groupnorm
    out = out * F.silu(g)
    tm = einsum("bsnd,ndh->bsh", out, cast(p["w_tmo"], rt))
    x = x + constrain(tm, rules, (BATCH, SEQ, EMB))

    # channel mix
    hc = rms_norm(p["ln_cm"], x)
    shifted_c = _token_shift(hc, cache["shift_cm"] if cache is not None
                             else None)
    mk = hc + (shifted_c - hc) * cast(p["mu_ck"], rt)
    mr = hc + (shifted_c - hc) * cast(p["mu_cr"], rt)
    kk = torch.square(F.relu(matmul(mk, cast(p["w_ck"], rt))))
    rr = torch.sigmoid(matmul(mr, cast(p["w_cr"], rt)))
    x = x + constrain(matmul(kk, cast(p["w_cv"], rt)) * rr, rules,
                      (BATCH, SEQ, EMB))

    new_cache = None
    if cache is not None:
        copy_into(cache["shift_tm"], h[:, -1])
        copy_into(cache["shift_cm"], hc[:, -1])
        new_cache = {"wkv": cache["wkv"], "shift_tm": cache["shift_tm"],
                     "shift_cm": cache["shift_cm"]}
    return x, new_cache
