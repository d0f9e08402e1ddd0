"""STG module templates (paper §IV-B1, Table II).

Every template builds a symbolic subgraph through a
:class:`~repro_torch.core.stg.GraphBuilder` and annotates weights with
*sharding roles* the distributor maps onto mesh axes:

* ``tp_col``  — Megatron column-parallel (shard an output dim),
* ``tp_row``  — row-parallel (shard a contraction dim → PartialSum out),
* ``kv_heads`` — shard only if the kv-head count divides tp (MQA/GQA),
* ``vocab``   — vocab-parallel embedding / LM head,
* ``expert``  — expert-parallel MoE weights.

Templates make *structural* decisions (e.g. sliding-window slicing) from
the concrete env, exactly like the paper's generator, but all shapes stay
symbolic.  Attention-internal tensors are tagged ``fused`` (flash-attn
fusion: they are not stored for backward — §V-C "Attn is the fused
kernel").
"""
from __future__ import annotations

from typing import Optional

import sympy as sp

from .stg import CAT_ATTN, CAT_EW, CAT_GEMM, CAT_OTHER, GraphBuilder
from .symbolic import (B, Dff, DH, E, Env, H, K, L, NH, NKV, R, S, SH, Senc,
                       Skv, V, sym)
from .tensor import STensor

G = sym("G")            # query groups per kv head (NH = NKV * G)
Din = sym("Din")        # SSM inner dim
Pst = sym("Pst")        # SSM state dim
DTR = sym("DTR")        # SSM dt rank
WN = sym("WN")          # sliding-window kv length
Rq = sym("Rq")          # MLA q lora rank
DR = sym("DR")          # MLA rope head dim
DN = sym("DN")          # MLA nope head dim
DV = sym("DV")          # MLA v head dim
Cap = sym("Cap")        # MoE expert capacity (bound to B*S*K/E at instantiation)
Dffe = sym("Dffe")      # MoE per-expert ffn dim
Sv = sym("Sv")          # vision tokens (VLM stub frontend)


def _w(b: GraphBuilder, name: str, shape, roles: Optional[dict] = None,
       dtype: str = "bf16") -> STensor:
    w = b.weight(name, shape, dtype)
    w.roles = dict(roles or {})
    return w


def embedding(b: GraphBuilder, *, prefix: str = "", seq=S) -> STensor:
    tags = {"layer": -1, "module": "embed"}
    ids = b.input(f"{prefix}tokens", (B, seq), "int32")
    table = _w(b, f"{prefix}w_embed", (V, H), {0: "vocab"})
    return b.embed(f"{prefix}embed", table, ids, tags=tags)


def rmsnorm(b: GraphBuilder, x: STensor, name: str, tags: dict) -> STensor:
    w = _w(b, f"w_{name}", (x.shape[-1],))
    return b.norm(name, "rmsnorm", x, w, tags=tags)


# ---------------------------------------------------------------------------
# Attention family
# ---------------------------------------------------------------------------

def attention_gqa(b: GraphBuilder, x: STensor, layer: int, *,
                  kv_len=Skv, kv_cache: bool = False, cross_kv: Optional[STensor] = None,
                  qk_norm: bool = False, softcap: bool = False,
                  window: Optional[object] = None, causal: bool = True,
                  merged: bool = False,
                  prefix: str = "", tags_extra: Optional[dict] = None) -> STensor:
    """Multi-head / Grouped-Query / Multi-Query attention (Table II rows 1-2).

    Weights carry the head structure so GQA sharding semantics are exact:
    ``w_q[H, NKV, G, DH]`` shards kv-heads when possible, else query groups.
    """
    tags = {"layer": layer, "module": "attn", **(tags_extra or {})}
    ftags = {**tags, "fused": True}
    h = rmsnorm(b, x, f"{prefix}ln_attn{layer}", tags)

    if merged:
        return _attention_merged(b, x, h, layer, kv_len=kv_len,
                                 kv_cache=kv_cache, prefix=prefix, tags=tags,
                                 ftags=ftags)
    w_q = _w(b, f"{prefix}w_q{layer}", (H, NKV, G, DH), {1: "kv_heads", 2: "tp_col"})
    q = b.einsum(f"{prefix}q{layer}", "bsh,hngd->bsngd", [h, w_q], tags=tags)

    kv_src = cross_kv if cross_kv is not None else h
    if kv_cache:
        # decode: keys/values for the full context come from the cache
        k = b.input(f"{prefix}kcache{layer}", (B, kv_len, NKV, DH))
        v = b.input(f"{prefix}vcache{layer}", (B, kv_len, NKV, DH))
        if cross_kv is None:
            # self-attn decode still projects the new token's k/v (cache append)
            w_k = _w(b, f"{prefix}w_k{layer}", (H, NKV, DH), {1: "kv_heads", 2: "tp_col"})
            w_v = _w(b, f"{prefix}w_v{layer}", (H, NKV, DH), {1: "kv_heads", 2: "tp_col"})
            # output is a cache write (side effect), not a dataflow edge
            b.einsum(f"{prefix}knew{layer}", "bsh,hnd->bsnd", [h, w_k],
                     tags={**tags, "sink": "kv_cache"})
            b.einsum(f"{prefix}vnew{layer}", "bsh,hnd->bsnd", [h, w_v],
                     tags={**tags, "sink": "kv_cache"})
    else:
        w_k = _w(b, f"{prefix}w_k{layer}", (H, NKV, DH), {1: "kv_heads", 2: "tp_col"})
        w_v = _w(b, f"{prefix}w_v{layer}", (H, NKV, DH), {1: "kv_heads", 2: "tp_col"})
        k = b.einsum(f"{prefix}k{layer}", "bth,hnd->btnd", [kv_src, w_k], tags=tags)
        v = b.einsum(f"{prefix}v{layer}", "bth,hnd->btnd", [kv_src, w_v], tags=tags)

    if qk_norm:
        q = b.norm(f"{prefix}qnorm{layer}", "rmsnorm", q,
                   _w(b, f"{prefix}w_qn{layer}", (DH,)), tags=tags)
        k = b.norm(f"{prefix}knorm{layer}", "rmsnorm", k,
                   _w(b, f"{prefix}w_kn{layer}", (DH,)), tags=tags)
    if cross_kv is None:
        q = b.map(f"{prefix}rope_q{layer}", "rope", [q], flop_per_elem=6, tags=tags)
        if not kv_cache:
            k = b.map(f"{prefix}rope_k{layer}", "rope", [k], flop_per_elem=6, tags=tags)

    if window is not None:
        # sliding-window: only the last WN kv positions participate
        k = b.slice_like(f"{prefix}kwin{layer}", k, (B, WN, NKV, DH), tags=tags)
        v = b.slice_like(f"{prefix}vwin{layer}", v, (B, WN, NKV, DH), tags=tags)

    scores = b.einsum(f"{prefix}scores{layer}", "bsngd,bknd->bngsk", [q, k],
                      category=CAT_ATTN, tags=ftags)
    if softcap:
        scores = b.map(f"{prefix}softcap{layer}", "tanh_cap", [scores],
                       flop_per_elem=4, category=CAT_ATTN, tags=ftags)
    p = b.softmax(f"{prefix}probs{layer}", scores, category=CAT_ATTN, tags=ftags)
    ctx = b.einsum(f"{prefix}ctx{layer}", "bngsk,bknd->bsngd", [p, v],
                   category=CAT_ATTN, tags=ftags)
    w_o = _w(b, f"{prefix}w_o{layer}", (NKV, G, DH, H), {0: "kv_heads", 1: "tp_col"})
    out = b.einsum(f"{prefix}attnout{layer}", "bsngd,ngdh->bsh", [ctx, w_o], tags=tags)
    return b.map(f"{prefix}res_attn{layer}", "add", [x, out], linear=True, tags=tags)


def _attention_merged(b: GraphBuilder, x: STensor, h: STensor, layer: int, *,
                      kv_len=Skv, kv_cache: bool = False, prefix: str = "",
                      tags=None, ftags=None) -> STensor:
    """Megatron-style layout: q/o carry the merged NH head dim (shardable
    even when NKV doesn't divide tp); k/v are repeated to NH per-rank —
    the exact duplication Megatron performs for MQA/GQA under TP."""
    w_q = _w(b, f"{prefix}w_qm{layer}", (H, NH, DH), {1: "tp_col"})
    q = b.einsum(f"{prefix}q{layer}", "bsh,hnd->bsnd", [h, w_q], tags=tags)
    q = b.map(f"{prefix}rope_q{layer}", "rope", [q], flop_per_elem=6, tags=tags)
    if kv_cache:
        k0 = b.input(f"{prefix}kcache{layer}", (B, kv_len, NKV, DH))
        v0 = b.input(f"{prefix}vcache{layer}", (B, kv_len, NKV, DH))
    else:
        w_k = _w(b, f"{prefix}w_k{layer}", (H, NKV, DH), {1: "kv_heads"})
        w_v = _w(b, f"{prefix}w_v{layer}", (H, NKV, DH), {1: "kv_heads"})
        k0 = b.einsum(f"{prefix}k{layer}", "bth,hmd->btmd", [h, w_k], tags=tags)
        k0 = b.map(f"{prefix}rope_k{layer}", "rope", [k0], flop_per_elem=6,
                   tags=tags)
        v0 = b.einsum(f"{prefix}v{layer}", "bth,hmd->btmd", [h, w_v], tags=tags)
    # repeat kv heads to NH (local duplication under TP)
    k = b.slice_like(f"{prefix}krep{layer}", k0, (B, kv_len, NH, DH), tags=tags)
    v = b.slice_like(f"{prefix}vrep{layer}", v0, (B, kv_len, NH, DH), tags=tags)
    s = b.einsum(f"{prefix}scores{layer}", "bsnd,btnd->bnst", [q, k],
                 category=CAT_ATTN, tags=ftags)
    p = b.softmax(f"{prefix}probs{layer}", s, category=CAT_ATTN, tags=ftags)
    ctx = b.einsum(f"{prefix}ctx{layer}", "bnst,btnd->bsnd", [p, v],
                   category=CAT_ATTN, tags=ftags)
    w_o = _w(b, f"{prefix}w_om{layer}", (NH, DH, H), {0: "tp_row"})
    out = b.einsum(f"{prefix}attnout{layer}", "bsnd,ndh->bsh", [ctx, w_o],
                   tags=tags)
    return b.map(f"{prefix}res_attn{layer}", "add", [x, out], linear=True,
                 tags=tags)


def attention_mla(b: GraphBuilder, x: STensor, layer: int, *,
                  kv_len=Skv, kv_cache: bool = False,
                  prefix: str = "", tags_extra: Optional[dict] = None) -> STensor:
    """Multi-head Latent Attention (DeepSeek-V2, Table II row 3).

    KV is compressed to a rank-R latent (plus a shared rope key); at decode
    only the latent + rope key are cached — the MLA memory win."""
    tags = {"layer": layer, "module": "mla", **(tags_extra or {})}
    ftags = {**tags, "fused": True}
    h = rmsnorm(b, x, f"{prefix}ln_attn{layer}", tags)

    w_dq = _w(b, f"{prefix}w_dq{layer}", (H, Rq))
    cq = b.einsum(f"{prefix}cq{layer}", "bsh,hr->bsr", [h, w_dq], tags=tags)
    cq = rmsnorm(b, cq, f"{prefix}ln_q{layer}", tags)
    w_uqn = _w(b, f"{prefix}w_uq_nope{layer}", (Rq, NH, DN), {1: "tp_col"})
    w_uqr = _w(b, f"{prefix}w_uq_rope{layer}", (Rq, NH, DR), {1: "tp_col"})
    qn = b.einsum(f"{prefix}q_nope{layer}", "bsr,rnd->bsnd", [cq, w_uqn], tags=tags)
    qr = b.einsum(f"{prefix}q_rope{layer}", "bsr,rnd->bsnd", [cq, w_uqr], tags=tags)
    qr = b.map(f"{prefix}rope_q{layer}", "rope", [qr], flop_per_elem=6, tags=tags)

    if kv_cache:
        ckv = b.input(f"{prefix}ckv_cache{layer}", (B, kv_len, R))
        kr = b.input(f"{prefix}kr_cache{layer}", (B, kv_len, DR))
        w_dkv = _w(b, f"{prefix}w_dkv{layer}", (H, R))
        b.einsum(f"{prefix}ckv_new{layer}", "bsh,hr->bsr", [h, w_dkv],
                 tags={**tags, "sink": "kv_cache"})
    else:
        w_dkv = _w(b, f"{prefix}w_dkv{layer}", (H, R))
        ckv = b.einsum(f"{prefix}ckv{layer}", "bth,hr->btr", [h, w_dkv], tags=tags)
        ckv = rmsnorm(b, ckv, f"{prefix}ln_kv{layer}", tags)
        w_kr = _w(b, f"{prefix}w_kr{layer}", (H, DR))
        kr = b.einsum(f"{prefix}kr{layer}", "bth,hd->btd", [h, w_kr], tags=tags)
        kr = b.map(f"{prefix}rope_k{layer}", "rope", [kr], flop_per_elem=6, tags=tags)

    w_uk = _w(b, f"{prefix}w_uk{layer}", (R, NH, DN), {1: "tp_col"})
    w_uv = _w(b, f"{prefix}w_uv{layer}", (R, NH, DV), {1: "tp_col"})
    kn = b.einsum(f"{prefix}k_nope{layer}", "btr,rnd->btnd", [ckv, w_uk], tags=tags)
    vv = b.einsum(f"{prefix}v{layer}", "btr,rnd->btnd", [ckv, w_uv], tags=tags)

    s1 = b.einsum(f"{prefix}scores_n{layer}", "bsnd,btnd->bnst", [qn, kn],
                  category=CAT_ATTN, tags=ftags)
    s2 = b.einsum(f"{prefix}scores_r{layer}", "bsnd,btd->bnst", [qr, kr],
                  category=CAT_ATTN, tags=ftags)
    scores = b.map(f"{prefix}scores{layer}", "add", [s1, s2], linear=True,
                   category=CAT_ATTN, tags=ftags)
    p = b.softmax(f"{prefix}probs{layer}", scores, category=CAT_ATTN, tags=ftags)
    ctx = b.einsum(f"{prefix}ctx{layer}", "bnst,btnd->bsnd", [p, vv],
                   category=CAT_ATTN, tags=ftags)
    w_o = _w(b, f"{prefix}w_o{layer}", (NH, DV, H), {0: "tp_row"})
    out = b.einsum(f"{prefix}attnout{layer}", "bsnd,ndh->bsh", [ctx, w_o], tags=tags)
    return b.map(f"{prefix}res_attn{layer}", "add", [x, out], linear=True, tags=tags)


# ---------------------------------------------------------------------------
# Sequence-mixers without attention
# ---------------------------------------------------------------------------

def mamba_block(b: GraphBuilder, x: STensor, layer: int, *,
                prefix: str = "", tags_extra: Optional[dict] = None) -> STensor:
    """Selective SSM block — the paper's Table X template, plus the in/out
    projections and gating of a full Mamba layer."""
    tags = {"layer": layer, "module": "ssm", **(tags_extra or {})}
    h = rmsnorm(b, x, f"{prefix}ln_ssm{layer}", tags)

    w_in = _w(b, f"{prefix}w_in{layer}", (H, 2 * Din), {1: "tp_col"})
    xz = b.einsum(f"{prefix}in_proj{layer}", "bsh,hi->bsi", [h, w_in], tags=tags)
    xs = b.slice_like(f"{prefix}x{layer}", xz, (B, S, Din), tags=tags)
    z = b.slice_like(f"{prefix}z{layer}", xz, (B, S, Din), tags=tags)
    xs = b.map(f"{prefix}conv{layer}", "causal_conv4", [xs], flop_per_elem=8, tags=tags)
    xs = b.map(f"{prefix}silu{layer}", "silu", [xs], flop_per_elem=4, tags=tags)

    # Table X: dt1/dt (low-rank Δ), dA, dB, ΔB·x, pscan, readout
    w_xdb = _w(b, f"{prefix}w_xdb{layer}", (Din, DTR + 2 * Pst), {0: "tp_row"})
    xdb = b.einsum(f"{prefix}x_db{layer}", "bsi,ir->bsr", [xs, w_xdb], tags=tags)
    dt0 = b.slice_like(f"{prefix}dt0{layer}", xdb, (B, S, DTR), tags=tags)
    Bt = b.slice_like(f"{prefix}B{layer}", xdb, (B, S, Pst), tags=tags)
    Ct = b.slice_like(f"{prefix}C{layer}", xdb, (B, S, Pst), tags=tags)
    w_dt = _w(b, f"{prefix}w_dt{layer}", (DTR, Din), {1: "tp_col"})
    dt = b.einsum(f"{prefix}dt{layer}", "bsr,ri->bsi", [dt0, w_dt], tags=tags)
    dt = b.map(f"{prefix}softplus{layer}", "softplus", [dt], flop_per_elem=4, tags=tags)

    A = _w(b, f"{prefix}A{layer}", (Din, Pst), {0: "tp_col"}, dtype="fp32")
    dA = b.einsum(f"{prefix}dA{layer}", "ip,bsi->bsip", [A, dt],
                  category=CAT_EW, tags=tags)
    dA = b.map(f"{prefix}exp_dA{layer}", "exp", [dA], flop_per_elem=2, tags=tags)
    dB = b.einsum(f"{prefix}dB{layer}", "bsp,bsi->bsip", [Bt, dt],
                  category=CAT_EW, tags=tags)
    dBx = b.einsum(f"{prefix}dBx{layer}", "bsip,bsi->bsip", [dB, xs],
                   category=CAT_EW, tags=tags)
    hs = b.pscan(f"{prefix}pscan{layer}", dA, dBx, seq_dim=1, tags=tags)
    y0 = b.einsum(f"{prefix}y0{layer}", "bsip,bsp->bsi", [hs, Ct],
                  category=CAT_ATTN, tags=tags)
    D = _w(b, f"{prefix}D{layer}", (Din,), {0: "tp_col"})
    dx = b.map(f"{prefix}Dx{layer}", "mul", [xs, D], tags=tags)
    y = b.map(f"{prefix}y{layer}", "add", [y0, dx], linear=True, tags=tags)
    zs = b.map(f"{prefix}zgate{layer}", "silu_mul", [y, z], flop_per_elem=5, tags=tags)
    w_out = _w(b, f"{prefix}w_outp{layer}", (Din, H), {0: "tp_row"})
    out = b.einsum(f"{prefix}ssm_out{layer}", "bsi,ih->bsh", [zs, w_out], tags=tags)
    return b.map(f"{prefix}res_ssm{layer}", "add", [x, out], linear=True, tags=tags)


def rwkv6_block(b: GraphBuilder, x: STensor, layer: int, *,
                prefix: str = "", tags_extra: Optional[dict] = None) -> STensor:
    """RWKV-6 (Finch) time-mix with data-dependent decay + channel-mix."""
    tags = {"layer": layer, "module": "rwkv", **(tags_extra or {})}
    h = rmsnorm(b, x, f"{prefix}ln_tm{layer}", tags)

    # token-shift interpolation for r/k/v/w/g (data-dependent, lora-style)
    mixed = {}
    for nm in ("r", "k", "v", "w", "g"):
        mx = _w(b, f"{prefix}mu_{nm}{layer}", (H,))
        mixed[nm] = b.map(f"{prefix}shift_{nm}{layer}", "lerp_shift", [h, mx],
                          flop_per_elem=4, tags=tags)
    w_r = _w(b, f"{prefix}w_r{layer}", (H, NH, DH), {1: "tp_col"})
    w_k = _w(b, f"{prefix}w_kk{layer}", (H, NH, DH), {1: "tp_col"})
    w_v = _w(b, f"{prefix}w_vv{layer}", (H, NH, DH), {1: "tp_col"})
    w_g = _w(b, f"{prefix}w_g{layer}", (H, NH, DH), {1: "tp_col"})
    r = b.einsum(f"{prefix}r{layer}", "bsh,hnd->bsnd", [mixed["r"], w_r], tags=tags)
    k = b.einsum(f"{prefix}k{layer}", "bsh,hnd->bsnd", [mixed["k"], w_k], tags=tags)
    v = b.einsum(f"{prefix}v{layer}", "bsh,hnd->bsnd", [mixed["v"], w_v], tags=tags)
    g = b.einsum(f"{prefix}g{layer}", "bsh,hnd->bsnd", [mixed["g"], w_g], tags=tags)

    # data-dependent decay: w = exp(-exp(lora(x)))  (the Finch novelty)
    w_d1 = _w(b, f"{prefix}w_dec1{layer}", (H, R))
    w_d2 = _w(b, f"{prefix}w_dec2{layer}", (R, NH, DH), {1: "tp_col"})
    d1 = b.einsum(f"{prefix}dec1{layer}", "bsh,hr->bsr", [mixed["w"], w_d1], tags=tags)
    dec = b.einsum(f"{prefix}dec2{layer}", "bsr,rnd->bsnd", [d1, w_d2], tags=tags)
    dec = b.map(f"{prefix}decay{layer}", "exp_neg_exp", [dec], flop_per_elem=4, tags=tags)

    kv = b.einsum(f"{prefix}kv{layer}", "bsnd,bsne->bsnde", [k, v],
                  category=CAT_ATTN, tags={**tags, "fused": True})
    dec5 = b.reshape(f"{prefix}dec5{layer}", dec, (B, S, NH, DH, sp.Integer(1)),
                     {0: 0, 1: 1, 2: 2, 3: 3}, tags=tags)
    state = b.pscan(f"{prefix}wkv{layer}", dec5, kv, seq_dim=1,
                    tags={**tags, "fused": True})
    out = b.einsum(f"{prefix}readout{layer}", "bsnd,bsnde->bsne", [r, state],
                   category=CAT_ATTN, tags={**tags, "fused": True})
    u = _w(b, f"{prefix}u{layer}", (NH, DH), {0: "tp_col"})
    ru = b.map(f"{prefix}ru{layer}", "mul", [r, u], tags=tags)
    bonus = b.einsum(f"{prefix}bonus{layer}", "bsnd,bsnde->bsne", [ru, kv],
                     category=CAT_ATTN, tags={**tags, "fused": True})
    out = b.map(f"{prefix}out_sum{layer}", "add", [out, bonus], linear=True, tags=tags)
    out = b.norm(f"{prefix}gn{layer}", "groupnorm", out,
                 _w(b, f"{prefix}w_gn{layer}", (DH,)), tags=tags)
    out = b.map(f"{prefix}ggate{layer}", "silu_mul", [out, g], flop_per_elem=5, tags=tags)
    w_o = _w(b, f"{prefix}w_tmo{layer}", (NH, DH, H), {0: "tp_row"})
    tm = b.einsum(f"{prefix}tm_out{layer}", "bsnd,ndh->bsh", [out, w_o], tags=tags)
    x = b.map(f"{prefix}res_tm{layer}", "add", [x, tm], linear=True, tags=tags)

    # channel-mix
    tags_cm = {**tags, "module": "rwkv_cm"}
    hc = rmsnorm(b, x, f"{prefix}ln_cm{layer}", tags_cm)
    mk = b.map(f"{prefix}shift_ck{layer}", "lerp_shift",
               [hc, _w(b, f"{prefix}mu_ck{layer}", (H,))], flop_per_elem=4, tags=tags_cm)
    mr = b.map(f"{prefix}shift_cr{layer}", "lerp_shift",
               [hc, _w(b, f"{prefix}mu_cr{layer}", (H,))], flop_per_elem=4, tags=tags_cm)
    w_ck = _w(b, f"{prefix}w_ck{layer}", (H, Dff), {1: "tp_col"})
    kk = b.einsum(f"{prefix}cm_k{layer}", "bsh,hf->bsf", [mk, w_ck], tags=tags_cm)
    kk = b.map(f"{prefix}relu2{layer}", "relu_sq", [kk], flop_per_elem=2, tags=tags_cm)
    w_cv = _w(b, f"{prefix}w_cv{layer}", (Dff, H), {0: "tp_row"})
    vv = b.einsum(f"{prefix}cm_v{layer}", "bsf,fh->bsh", [kk, w_cv], tags=tags_cm)
    w_cr = _w(b, f"{prefix}w_cr{layer}", (H, H))
    rr = b.einsum(f"{prefix}cm_r{layer}", "bsh,hg->bsg", [mr, w_cr], tags=tags_cm)
    gated = b.map(f"{prefix}cm_gate{layer}", "sigmoid_mul", [vv, rr],
                  flop_per_elem=5, tags=tags_cm)
    return b.map(f"{prefix}res_cm{layer}", "add", [x, gated], linear=True, tags=tags_cm)


# ---------------------------------------------------------------------------
# Feed-forward family
# ---------------------------------------------------------------------------

def ffn(b: GraphBuilder, x: STensor, layer: int, *, gated: bool = True,
        width=Dff, prefix: str = "", module: str = "ffn",
        tags_extra: Optional[dict] = None) -> STensor:
    """Up-down (GPT) or gate-up-down (LLaMA) FFN (Table II rows 5-6)."""
    tags = {"layer": layer, "module": module, **(tags_extra or {})}
    h = rmsnorm(b, x, f"{prefix}ln_{module}{layer}", tags)
    w_up = _w(b, f"{prefix}w_up{layer}", (H, width), {1: "tp_col"})
    up = b.einsum(f"{prefix}up{layer}", "bsh,hf->bsf", [h, w_up], tags=tags)
    if gated:
        w_gate = _w(b, f"{prefix}w_gate{layer}", (H, width), {1: "tp_col"})
        gate = b.einsum(f"{prefix}gate{layer}", "bsh,hf->bsf", [h, w_gate], tags=tags)
        act = b.map(f"{prefix}swiglu{layer}", "silu_mul", [gate, up],
                    flop_per_elem=5, tags=tags)
    else:
        act = b.map(f"{prefix}gelu{layer}", "gelu", [up], flop_per_elem=8, tags=tags)
    w_down = _w(b, f"{prefix}w_down{layer}", (width, H), {0: "tp_row"})
    down = b.einsum(f"{prefix}down{layer}", "bsf,fh->bsh", [act, w_down], tags=tags)
    return b.map(f"{prefix}res_{module}{layer}", "add", [x, down], linear=True, tags=tags)


def moe(b: GraphBuilder, x: STensor, layer: int, *, shared: bool = True,
        prefix: str = "", tags_extra: Optional[dict] = None) -> STensor:
    """MoE with optional shared experts (GShard/Switch + DeepSeek-MoE,
    Table II rows 7-8).  EP communication (AllToAll dispatch/combine)
    emerges from the expert-dim sharding mismatch — no comm is scripted
    here."""
    tags = {"layer": layer, "module": "moe", **(tags_extra or {})}
    h = rmsnorm(b, x, f"{prefix}ln_moe{layer}", tags)
    w_r = _w(b, f"{prefix}w_router{layer}", (H, E))
    logits = b.einsum(f"{prefix}router{layer}", "bsh,he->bse", [h, w_r], tags=tags)
    probs = b.softmax(f"{prefix}rprobs{layer}", logits, tags=tags)
    gates, idx = b.topk(f"{prefix}topk{layer}", probs, K, tags=tags)

    xd = b.dispatch(f"{prefix}dispatch{layer}", h, idx, e=E, cap=Cap, tags=tags)
    w_ge = _w(b, f"{prefix}w_egate{layer}", (E, H, Dffe), {0: "expert"})
    w_ue = _w(b, f"{prefix}w_eup{layer}", (E, H, Dffe), {0: "expert"})
    w_de = _w(b, f"{prefix}w_edown{layer}", (E, Dffe, H), {0: "expert"})
    eg = b.einsum(f"{prefix}egate{layer}", "ech,ehf->ecf", [xd, w_ge], tags=tags)
    eu = b.einsum(f"{prefix}eup{layer}", "ech,ehf->ecf", [xd, w_ue], tags=tags)
    ea = b.map(f"{prefix}eswiglu{layer}", "silu_mul", [eg, eu],
               flop_per_elem=5, tags=tags)
    eo = b.einsum(f"{prefix}edown{layer}", "ecf,efh->ech", [ea, w_de], tags=tags)
    comb = b.dispatch(f"{prefix}combine{layer}", eo, idx,
                      out_shape=(B, x.shape[1], H), combine=True, tags=tags)
    gsum = b.reduce(f"{prefix}gsum{layer}", gates, dims=(2,), keepdims=True, tags=tags)
    routed = b.map(f"{prefix}gated{layer}", "mul", [comb, gsum], tags=tags)

    out = routed
    if shared:
        w_sg = _w(b, f"{prefix}w_sgate{layer}", (H, SH * Dffe), {1: "tp_col"})
        w_su = _w(b, f"{prefix}w_sup{layer}", (H, SH * Dffe), {1: "tp_col"})
        w_sd = _w(b, f"{prefix}w_sdown{layer}", (SH * Dffe, H), {0: "tp_row"})
        sg = b.einsum(f"{prefix}sgate{layer}", "bsh,hf->bsf", [h, w_sg], tags=tags)
        su = b.einsum(f"{prefix}sup{layer}", "bsh,hf->bsf", [h, w_su], tags=tags)
        sa = b.map(f"{prefix}sswiglu{layer}", "silu_mul", [sg, su],
                   flop_per_elem=5, tags=tags)
        so = b.einsum(f"{prefix}sdown{layer}", "bsf,fh->bsh", [sa, w_sd], tags=tags)
        out = b.map(f"{prefix}moe_mix{layer}", "add", [routed, so],
                    linear=True, tags=tags)
    return b.map(f"{prefix}res_moe{layer}", "add", [x, out], linear=True, tags=tags)


# ---------------------------------------------------------------------------
# Head / loss
# ---------------------------------------------------------------------------

def lm_head(b: GraphBuilder, x: STensor, *, softcap: bool = False,
            seq=S, prefix: str = "", n_layers_tag: Optional[int] = None) -> STensor:
    tags = {"module": "head"}
    if n_layers_tag is not None:
        tags["layer"] = n_layers_tag
    h = rmsnorm(b, x, f"{prefix}ln_final", tags)
    w_lm = _w(b, f"{prefix}w_lmhead", (H, V), {1: "vocab"})
    logits = b.einsum(f"{prefix}logits", "bsh,hv->bsv", [h, w_lm], tags=tags)
    if softcap:
        logits = b.map(f"{prefix}logit_cap", "tanh_cap", [logits],
                       flop_per_elem=4, tags=tags)
    labels = b.input(f"{prefix}labels", (B, seq), "int32")
    losses = b.cross_entropy(f"{prefix}ce", logits, labels, tags=tags)
    loss = b.reduce(f"{prefix}loss", losses, dims=(0, 1), fn="mean", tags=tags)
    b.graph.outputs.append(loss)
    return loss
