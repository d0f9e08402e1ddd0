"""The layer kinds of ``model_type`` ``deepseek_v2``: DeepSeek-V2's
multi-head latent attention (MLA) as the mixer ``mla`` of every layer, the
FFN (dense or MoE) chosen by ``first_k_dense_replace`` and
``moe_layer_freq`` as for deepseek-moe.  Torch only; it imports nothing of
the program.

The layer is the port's (``repro_torch.models.layers.init_mla`` /
``mla_attention``), with the source's keys: ``h = norm(x)``,
``cq = norm(h W_dq)``, ``q_nope = cq W_uq_n``, ``q_rope = RoPE(cq W_uq_r)``,
``c = norm(h W_dkv)``, ``k_nope = c W_uk``, ``v = c W_uv``,
``k_rope = RoPE(h W_kr)`` (one key shared by all heads), causal softmax
over ``[q_nope, q_rope] . [k_nope, k_rope]`` scaled by
``1/sqrt(nope + rope)``, the heads' outputs through ``W_o``.

Where the port departs from arXiv:2405.04434 and the source's config.json,
the reference follows the port:

* plain RoPE at ``rope_theta``, not the config's YaRN ``rope_scaling``
  (factor 40, mscale 0.707, ``original_max_position_embeddings`` 4096);
* the MoE's top-k gates renormalised over the K picks of a softmax over
  all experts, not ``topk_method`` ``group_limited_greedy`` (``n_group``
  8, ``topk_group`` 3) scaled by ``routed_scaling_factor`` 16;
* expert capacity ``ceil(T*K/E*1.25)`` a dispatch, later picks dropped
  (the source drops none).

Both counts below are of the model's own computation, whatever path the
program takes: a decode that absorbs ``W_uk`` into the query and ``W_uv``
into ``W_o`` reads the same counts."""
from __future__ import annotations

import math

import torch

from .. import weights as W
from .model import _rope

# the fp32 q, k, v and output of a block of rows stay under this many bytes
ROW_BLOCK_BYTES = 1 << 32
# a block of attention scores stays under this many bytes
SCORE_BLOCK_BYTES = 1 << 30
Q_BLOCK = 1024


def layer_kind(cfg: dict, layer: int) -> tuple:
    return "mla", W.default_layer_kind(cfg, layer)[1]


def _widths(cfg: dict) -> tuple:
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def leaves(cfg: dict) -> dict:
    """The port's ``init_mla`` tree: {leaf: (shape, fan_in | rule)}."""
    H, N, ql, kl, nope, rope, dv = _widths(cfg)
    return {"ln": ((H,), "one"), "w_dq": ((H, ql), H),
            "ln_q": ((ql,), "one"), "w_uq_n": ((ql, N, nope), ql),
            "w_uq_r": ((ql, N, rope), ql), "w_dkv": ((H, kl), H),
            "ln_kv": ((kl,), "one"), "w_kr": ((H, rope), H),
            "w_uk": ((kl, N, nope), kl), "w_uv": ((kl, N, dv), kl),
            "w_o": ((N, dv, H), N * dv)}


def params_per_token(cfg: dict) -> int:
    """W_dq, W_uq (nope and rope), W_dkv, W_kr, W_uk and W_uv, W_o."""
    H, N, ql, kl, nope, rope, dv = _widths(cfg)
    return H * ql + ql * N * (nope + rope) + H * kl + H * rope \
        + kl * N * (nope + dv) + N * dv * H


def flops_per_position(cfg: dict) -> int:
    """QK^T over nope + rope and PV over v, for every head."""
    _, N, _, _, nope, rope, dv = _widths(cfg)
    return 2 * N * (nope + rope) + 2 * N * dv


def reference(ref, p: dict, x: torch.Tensor, grouping: str) -> torch.Tensor:
    """The layer's output [B, T, H] (without the residual) in the
    reference's precision, over positions 0..T-1 of each row.  The
    expanded q, k, v of all heads are made for a block of rows at a time,
    and the scores for a block of queries against the keys up to its
    last."""
    del grouping                      # attention is the same in both
    H, N, ql, kl, nope, rope, dv = _widths(ref.cfg)
    b, t, _ = x.shape
    theta = ref.cfg.get("rope_theta", 10000.0)
    pos = torch.arange(t, device=x.device, dtype=torch.float32)
    h = ref.norm(x, p["ln"])
    cq = ref.a(ref.norm(ref.mm(h, p["w_dq"]), p["ln_q"]))        # [b,t,ql]
    c = ref.a(ref.norm(ref.mm(h, p["w_dkv"]), p["ln_kv"]))       # [b,t,kl]
    kr = _rope(ref.mm(h, p["w_kr"]), pos, theta)                 # [b,t,rope]
    w_qn, w_qr = ref.w(p["w_uq_n"]), ref.w(p["w_uq_r"])
    w_uk, w_uv, w_o = ref.w(p["w_uk"]), ref.w(p["w_uv"]), ref.w(p["w_o"])
    scale = 1.0 / math.sqrt(nope + rope)
    out = x.new_empty(b, t, H)
    per_row = 4 * t * N * 2 * (nope + rope + dv)
    rows = max(1, min(b, ROW_BLOCK_BYTES // per_row))
    kpos = torch.arange(t, device=x.device)
    for b0 in range(0, b, rows):
        rb = slice(b0, min(b, b0 + rows))
        q = torch.cat([torch.einsum("btr,rnd->btnd", cq[rb], w_qn),
                       _rope(torch.einsum("btr,rnd->btnd", cq[rb], w_qr),
                             pos, theta)], dim=-1)               # [r,t,N,D]
        k = torch.cat([torch.einsum("btr,rnd->btnd", c[rb], w_uk),
                       kr[rb, :, None].expand(-1, -1, N, rope)], dim=-1)
        v = torch.einsum("btr,rnd->btnd", c[rb], w_uv)            # [r,t,N,dv]
        o = torch.empty_like(v)
        nr = q.shape[0]
        qb = max(1, min(Q_BLOCK, SCORE_BLOCK_BYTES // (4 * nr * N * t)))
        for q0 in range(0, t, qb):
            q1 = min(t, q0 + qb)
            s = torch.einsum("bsnd,bknd->bnsk", q[:, q0:q1], k[:, :q1]) \
                * scale
            mask = kpos[None, :q1] <= torch.arange(q0, q1,
                                                   device=x.device)[:, None]
            s = s.masked_fill(~mask, float("-inf"))
            o[:, q0:q1] = torch.einsum("bnsk,bknd->bsnd",
                                       torch.softmax(s, dim=-1), v[:, :q1])
        out[rb] = torch.einsum("btnd,ndh->bth", ref.a(o), w_o)
    return out


KINDS = {"mla": {"key": "attn", "leaves": leaves, "reference": reference,
                 "params_per_token": params_per_token,
                 "flops_per_position": flops_per_position}}
