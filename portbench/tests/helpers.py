"""Smoke-size runs of the harness on the CPU."""
import contextlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import torch

DATA = Path(__file__).resolve().parent / "data"
# run -> (the cell whose name it runs under, config, traffic, window in
# seconds of ``fixed_clock``): 100 decode steps, two prefill cycles;
# sixteen for deepseek's prefill, whose check judges sixteen batches of its
# shortest prompts.  The ``mla.`` runs take a config that brings its own
# layer kind (``reference/deepseek_v2.py``) through the cells of its
# traffic.
CELLS = {
    "jamba52b.decode-chat8": ("jamba52b.decode-chat8", "smoke-jamba",
                              "decode-small", 1.0),
    "jamba52b.prefill-mix8k": ("jamba52b.prefill-mix8k", "smoke-jamba",
                               "prefill-small", 0.02),
    "dsmoe16b.prefill-mix8k": ("dsmoe16b.prefill-mix8k", "smoke-deepseek",
                               "prefill-small", 0.16),
    "mla.decode-small": ("jamba52b.decode-chat8", "smoke-deepseek-v2",
                         "decode-small", 1.0),
    "mla.prefill-small": ("dsmoe16b.prefill-mix8k", "smoke-deepseek-v2",
                          "prefill-small", 0.16),
}
TICK = 0.01
DECODE = [c for c in CELLS if ".decode" in c]
PREFILL = [c for c in CELLS if ".prefill" in c]


# DeepSeek-V2's config.json (https://huggingface.co/deepseek-ai/DeepSeek-V2,
# arXiv:2405.04434), the keys that give its shape
DEEPSEEK_V2 = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 5120, "intermediate_size": 12288, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1536, "moe_layer_freq": 1, "n_group": 8,
    "n_routed_experts": 160, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 128, "num_experts_per_tok": 6,
    "num_hidden_layers": 60, "num_key_value_heads": 128, "q_lora_rank": 1536,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 16, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 3,
    "topk_method": "group_limited_greedy", "v_head_dim": 128,
    "vocab_size": 102400,
}


def deepseek_v2(layers: int = 60) -> dict:
    """DeepSeek-V2 at its published widths as a configuration of the
    harness, cut to its first ``layers`` layers (the dense one, then MoE
    layers of all 160 experts), with its layer kinds from
    ``reference/deepseek_v2.py``."""
    spec = {"name": "deepseek-v2-236b", "n_layers": layers, "d_model": 5120,
            "n_heads": 128, "n_kv_heads": 128, "d_ff": 12288,
            "vocab": 102400, "d_head": 128, "block": "mla",
            "mla": {"kv_lora": 512, "q_lora": 1536, "rope_dim": 64,
                    "nope_dim": 128, "v_dim": 128},
            "moe": {"n_experts": 160, "top_k": 6, "n_shared": 2,
                    "d_expert": 1536, "first_dense": True}}
    return dict(DEEPSEEK_V2, num_hidden_layers=layers,
                reduced={"num_hidden_layers": 60} if layers != 60 else {},
                assumed={"moe_capacity_factor": 1.25},
                served_dtype="bfloat16", fp32_leaves=["w_router"],
                port={"spec": spec, "prefix_layers": 1, "period": 1})


def load(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def smoke(run: str) -> dict:
    cell, cfg, mix, secs = CELLS[run]
    return {"cell": cell, "cfg": load(cfg), "mix": load(mix),
            "check": load("smoke-limits")[run], "seconds": secs}


@contextlib.contextmanager
def fixed_clock():
    """The load generators' clock advances ``TICK`` seconds a reading, so that a
    window holds the same steps however fast the CPU is."""
    from portbench.kinds import closed_loop, prefill_batches
    now = [0.0]

    def tick():
        now[0] += TICK
        return now[0]
    fake = SimpleNamespace(perf_counter=tick)
    mods = (closed_loop, prefill_batches)
    saved = [m.time for m in mods]
    for m in mods:
        m.time = fake
    try:
        yield
    finally:
        for m, t in zip(mods, saved):
            m.time = t


def run(name: str, seed: int = 1, trace: bool = False) -> tuple:
    s = smoke(name)
    from portbench import core
    with fixed_clock():
        return core.run_cell(s["cell"], seed, s["seconds"], trace,
                             torch.device("cpu"), time.perf_counter(),
                             cfg=s["cfg"], mix=s["mix"], check=s["check"])
