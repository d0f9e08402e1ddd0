"""Model assembly: repeat + connect module templates into a full STG
(paper §IV-A step 2), for every architecture family in the assignment.

``ModelSpec`` is the user-facing "target model" input; ``build_graph``
assembles forward (+loss, +backward, +optimizer for training) graphs for
``train`` / ``prefill`` / ``decode`` modes.  ``bind_env`` grounds the
symbolic dims from the spec + workload shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import sympy as sp

from . import modules as M
from .stg import GraphBuilder, Graph, add_optimizer, backward
from .symbolic import Env


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # per-expert ffn width
    every: int = 1               # MoE every k-th layer (jamba: 2)
    first_dense: bool = False    # deepseek: layer 0 is a dense FFN


@dataclass(frozen=True)
class MLASpec:
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 16
    expand: int = 2
    dt_rank: int = 0             # 0 -> d_model/16


@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                        # 0 -> d_model // n_heads
    block: str = "gqa"                     # gqa | mla | mamba | rwkv6
    gated_ffn: bool = True
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    head_layout: str = "grouped"           # grouped | merged (Megatron MQA dup)
    qk_norm: bool = False
    softcap: bool = False                  # gemma2 logit/attn softcap (STG flag)
    attn_softcap: Optional[float] = None   # runtime: attention score cap value
    final_softcap: Optional[float] = None  # runtime: final logit cap value
    window: Optional[int] = None           # sliding-window size
    window_pattern: Optional[str] = None   # "alternate": even layers local
    attn_every: int = 1                    # hybrid: attention 1-in-k (jamba 8)
    attn_offset: int = 0                   # index within the period (jamba 4)
    encoder_layers: int = 0                # enc-dec (whisper)
    enc_seq: int = 1500                    # encoder frames (whisper stub)
    vision_seq: int = 0                    # prepended vision tokens (VLM stub)
    rwkv_decay_rank: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def params(self) -> float:
        """Total parameter count (for 6ND-style napkin math)."""
        H, L_, Df, Vc = self.d_model, self.n_layers, self.d_ff, self.vocab
        per_layer = 0.0
        dh, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        if self.block == "gqa":
            attn = H * nh * dh + 2 * H * nkv * dh + nh * dh * H
        elif self.block == "mla":
            m = self.mla or MLASpec()
            attn = (H * m.q_lora + m.q_lora * nh * (m.nope_dim + m.rope_dim)
                    + H * (m.kv_lora + m.rope_dim)
                    + m.kv_lora * nh * (m.nope_dim + m.v_dim) + nh * m.v_dim * H)
        elif self.block == "mamba":
            s = self.ssm or SSMSpec()
            din = s.expand * H
            dtr = s.dt_rank or H // 16
            attn = H * 2 * din + din * (dtr + 2 * s.d_state) + dtr * din \
                + din * s.d_state + din + din * H
        elif self.block == "rwkv6":
            attn = 4 * H * H + H * self.rwkv_decay_rank \
                + self.rwkv_decay_rank * H + H * H
        else:
            attn = 0.0

        n_attn_layers = sum(1 for l in range(L_) if self._is_attn_layer(l)) \
            if self.attn_every > 1 else L_
        n_seq_layers = L_ - n_attn_layers
        mix = n_attn_layers * attn
        if self.attn_every > 1:            # hybrid: non-attn layers are mamba
            s = self.ssm or SSMSpec()
            din = s.expand * H
            dtr = s.dt_rank or H // 16
            mamba = H * 2 * din + din * (dtr + 2 * s.d_state) + dtr * din \
                + din * s.d_state + din + din * H
            mix += n_seq_layers * mamba

        ff = 0.0
        for l in range(L_):
            if self._is_moe_layer(l):
                m = self.moe
                ff += m.n_experts * 3 * H * m.d_expert \
                    + m.n_shared * 3 * H * m.d_expert + H * m.n_experts
            elif self.block == "rwkv6":
                ff += H * Df + Df * H + H * H
            else:
                ff += (3 if self.gated_ffn else 2) * H * Df
        enc = self.encoder_layers * (4 * H * H + 2 * H * Df)
        return mix + ff + enc + 2 * Vc * H   # embed + lm head

    def active_params(self) -> float:
        """Activated parameters per token (MoE-aware, for 6·N_active·D)."""
        if not self.moe:
            return self.params()
        m = self.moe
        dead = sum(m.n_experts - m.top_k for l in range(self.n_layers)
                   if self._is_moe_layer(l)) * 3 * self.d_model * m.d_expert
        return self.params() - dead

    def _is_moe_layer(self, layer: int) -> bool:
        if not self.moe:
            return False
        if self.moe.first_dense and layer == 0:
            return False
        return layer % self.moe.every == (self.moe.every - 1 if self.moe.every > 1 else 0)

    def _is_attn_layer(self, layer: int) -> bool:
        if self.block in ("mamba", "rwkv6"):
            return False
        if self.attn_every <= 1:
            return True
        return layer % self.attn_every == self.attn_offset

    def _is_local_layer(self, layer: int) -> bool:
        return self.window is not None and (
            self.window_pattern != "alternate" or layer % 2 == 0)


def bind_env(spec: ModelSpec, *, batch: int, seq: int,
             kv_len: Optional[int] = None,
             mode: Optional[str] = None) -> Env:
    """Bind all model + workload symbols for instantiation.

    ``mode`` (when the caller knows it) tightens the binding for decode
    phases: ``kv_len`` becomes REQUIRED — the historical ``kv = seq``
    fallback would silently model a decode step against a 1-token cache
    — and the MoE expert capacity ``Cap`` is bound to the *expected*
    routed-token count of the actual phase shape, ``B*S*K/E`` exactly
    (possibly fractional), instead of ``max(1, ceil(...))``: with one
    token per sequence the ceiling floor would charge every expert a
    full token even when ``B*K << E``, inflating decode MoE cost by up
    to ``E/(B*K)`` (paper Table IX regime)."""
    m = spec.mla or MLASpec()
    s = spec.ssm or SSMSpec()
    moe = spec.moe or MoESpec(1, 1, 0, spec.d_ff)
    if mode == "decode" and kv_len is None:
        raise ValueError(
            "decode mode requires kv_len: a decode step is costed against "
            "an existing KV cache, and the kv=seq fallback (seq=1) would "
            "silently model a 1-token cache — pass kv_len=<context length> "
            "(e.g. Scenario.decode(batch=..., kv_len=...))")
    kv = kv_len if kv_len is not None else seq
    nkv = max(1, spec.n_kv_heads)
    if mode == "decode":
        cap = sp.Rational(batch * seq * moe.top_k, moe.n_experts)
    else:
        cap = max(1, math.ceil(batch * seq * moe.top_k / moe.n_experts))
    e = Env(
        B=batch, S=seq, Skv=kv,
        H=spec.d_model, Dff=spec.d_ff, V=spec.vocab,
        NH=spec.n_heads, NKV=nkv, G=max(1, spec.n_heads // nkv),
        DH=spec.head_dim, L=spec.n_layers,
        E=moe.n_experts, K=moe.top_k, SH=max(1, moe.n_shared),
        Dffe=moe.d_expert or spec.d_ff,
        Cap=cap,
        R=(m.kv_lora if spec.block == "mla" else spec.rwkv_decay_rank),
        Rq=m.q_lora, DR=m.rope_dim, DN=m.nope_dim, DV=m.v_dim,
        Din=s.expand * spec.d_model, Pst=s.d_state,
        DTR=s.dt_rank or spec.d_model // 16,
        WN=min(spec.window or kv, kv),
        Senc=spec.enc_seq, Sv=spec.vision_seq,
    )
    return e


def _decoder_layer(b: GraphBuilder, spec: ModelSpec, x, layer: int, *,
                   mode: str, cross_kv=None):
    kv_cache = mode == "decode"
    kv_len = M.Skv if kv_cache else M.S
    if spec._is_attn_layer(layer):
        if spec.block == "mla":
            x = M.attention_mla(b, x, layer, kv_len=kv_len, kv_cache=kv_cache)
        else:
            win = spec.window if spec._is_local_layer(layer) else None
            x = M.attention_gqa(b, x, layer, kv_len=kv_len, kv_cache=kv_cache,
                                qk_norm=spec.qk_norm, softcap=spec.softcap,
                                window=win,
                                merged=spec.head_layout == "merged")
    elif spec.block == "rwkv6":
        return M.rwkv6_block(b, x, layer)       # includes channel-mix "ffn"
    else:                                        # hybrid non-attn -> mamba
        x = M.mamba_block(b, x, layer)
    if spec.block == "rwkv6":
        return x
    if cross_kv is not None:
        x = M.attention_gqa(b, x, layer, kv_len=M.Senc,
                            kv_cache=kv_cache, cross_kv=cross_kv,
                            prefix="x", tags_extra={"sub": "cross"})
    if spec._is_moe_layer(layer):
        x = M.moe(b, x, layer, shared=(spec.moe.n_shared > 0))
    elif spec.block == "mamba" and not spec._is_attn_layer(layer) \
            and spec.attn_every <= 1:
        pass                                     # pure-mamba archs: no separate FFN
    else:
        width = M.Dff
        x = M.ffn(b, x, layer, gated=spec.gated_ffn, width=width)
    return x


def build_graph(spec: ModelSpec, *, mode: str = "train",
                with_backward: Optional[bool] = None) -> GraphBuilder:
    """Assemble the full-model STG.  ``mode``: train | prefill | decode."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    do_bwd = with_backward if with_backward is not None else (mode == "train")
    b = GraphBuilder()

    cross = None
    if spec.encoder_layers:
        if mode == "decode":
            # encoder ran during prefill; its (cached) output conditions decode
            cross = b.input("enc_out_cached", (M.B, M.Senc, M.H))
        else:
            # encoder (stub frontend: inputs are precomputed frame embeddings)
            enc = b.input("frames", (M.B, M.Senc, M.H))
            for l in range(spec.encoder_layers):
                enc = M.attention_gqa(b, enc, l, kv_len=M.Senc, causal=False,
                                      prefix="e", tags_extra={"sub": "enc"})
                enc = M.ffn(b, enc, l, gated=False, prefix="e", module="encffn")
            cross = M.rmsnorm(b, enc, "ln_enc_final",
                              {"layer": spec.encoder_layers - 1, "module": "enc"})

    x = M.embedding(b)
    if spec.vision_seq:
        # VLM stub frontend: precomputed patch embeddings prepended to text
        vis = b.input("vision_embeds", (M.B, M.Sv, M.H))
        x = b.concat("cat_vision", [vis, x], dim=1,
                     tags={"layer": -1, "module": "embed"})

    layer_off = spec.encoder_layers
    for l in range(spec.n_layers):
        x = _decoder_layer(b, spec, x, layer_off + l, mode=mode, cross_kv=cross)

    loss = M.lm_head(b, x, softcap=spec.softcap, seq=x.shape[1],
                     n_layers_tag=layer_off + spec.n_layers)
    if do_bwd:
        backward(b, loss)
        add_optimizer(b)
    b.graph.validate()
    return b


def total_layers(spec: ModelSpec) -> int:
    """Layer count used for pipeline-stage splitting."""
    return spec.encoder_layers + spec.n_layers
