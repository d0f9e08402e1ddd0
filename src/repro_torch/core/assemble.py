"""Model specification dataclasses (own copy of the target-model input of
``repro.core.assemble``; field for field the same, nothing that needs sympy).

``ModelSpec`` describes one architecture; the runtime reads its widths and
its layer pattern (``_is_moe_layer`` / ``_is_attn_layer`` /
``_is_local_layer``).  Graph assembly (``build_graph``, ``bind_env``) belongs
to the symbolic generator and is not part of this package yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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

