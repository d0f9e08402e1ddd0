"""The yardstick's arithmetic: the H100's peaks, the least time a flash
attention call could take, and the model FLOPs a token costs.  All of it is
worked out from shapes and from the configuration file's keys, never from
the program."""
from __future__ import annotations

from . import weights as W

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 rate, at
# the full 700 W power limit
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _pairs(sq: int, sk: int, causal: bool, window, q_offset: int) -> tuple:
    """(query-key pairs attended, keys some query sees) of one row of heads:
    query s at position q_offset + s sees keys lo..hi-1."""
    pairs, lo_min, hi_max = 0, sk, 0
    # closed forms would do; Sq is at most a few thousand rows per call
    for s in range(sq):
        qp = q_offset + s
        hi = min(sk, qp + 1) if causal else sk
        lo = max(0, qp - window + 1) if window else 0
        if hi > lo:
            pairs += hi - lo
            lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    return pairs, max(0, hi_max - lo_min)


def flash_bound_s(call: dict) -> float:
    """The least seconds of one attention call: the larger of its bytes
    over the memory rate (q and out once, each K and V row some query sees
    once) and its operations over the bf16 rate (2 (D + Dv) per attended
    pair and query head).  ``call``: shapes q [B,Sq,N,G,D], k [B,Sk,N,D],
    v [...,Dv], element size, causal, window, q_offset."""
    b, sq, n, g, d = call["q"]
    sk, dv = call["k"][1], call["v"][-1]
    pairs, keys = _pairs(sq, sk, call["causal"], call["window"],
                         call["q_offset"])
    nbytes = call["esize"] * (b * sq * n * g * (d + dv) + b * keys * n * (d + dv))
    ops = 2 * b * n * g * (d + dv) * pairs
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS_BF16)


def product_params_per_token(cfg: dict) -> float:
    """Parameters in the matrix products one token goes through: each
    layer kind's ``params_per_token`` (``weights.BUILTIN``: the attention
    layer's projections, the dense FFNs, the router, the top-k routed and
    all shared experts of each MoE layer, capacity padding and drops not
    counted), the LM head.  The embedding is a lookup, Mamba's conv and
    scan are elementwise: none counts."""
    table = W.kinds(cfg)
    total = cfg["hidden_size"] * cfg["vocab_size"]
    for l in range(cfg["num_hidden_layers"]):
        for kind in W.layer_kind(cfg, l):
            total += table[kind]["params_per_token"](cfg)
    return float(total)


def flops_per_position(cfg: dict) -> int:
    """Model FLOPs of one token for each position it attends, over all
    layers: each kind's ``flops_per_position`` (4 x heads x head dim for
    ``attn``: QK^T and PV), nothing for a kind that attends nothing
    (Mamba's scan, a dense or MoE FFN)."""
    table = W.kinds(cfg)
    total = 0
    for l in range(cfg["num_hidden_layers"]):
        for kind in W.layer_kind(cfg, l):
            per = table[kind].get("flops_per_position")
            total += per(cfg) if per is not None else 0
    return total


def model_flops(cfg: dict, tokens: int, attended: int) -> float:
    """Model FLOPs of ``tokens`` tokens that attend ``attended`` positions
    in all (summed over the tokens): 2 x product parameters a token, plus
    ``flops_per_position`` for each attended position."""
    return 2.0 * product_params_per_token(cfg) * tokens \
        + flops_per_position(cfg) * attended
