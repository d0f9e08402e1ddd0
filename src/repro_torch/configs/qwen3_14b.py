"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm [hf:Qwen/Qwen3-14B]."""
from ..core import ModelSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
                 n_kv_heads=8, d_ff=17408, vocab=151936, d_head=128,
                 qk_norm=True)
SMOKE = ModelSpec(name="qwen3-smoke", n_layers=3, d_model=128, n_heads=8,
                  n_kv_heads=2, d_ff=256, vocab=512, d_head=16, qk_norm=True)
# kv=8 / groups=5 don't divide the 16-way model axis: attention weights
# fall back to data(FSDP) sharding; MLP/vocab shard over model (DESIGN.md).
RUNTIME = RuntimeCfg()
SKIP = {}
