"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 => MQA) d_ff=24576
vocab=49152 — llama-arch code model [arXiv:2405.04324]."""
from ..core import ModelSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="granite-34b", n_layers=88, d_model=6144, n_heads=48,
                 n_kv_heads=1, d_ff=24576, vocab=49152, d_head=128)
SMOKE = ModelSpec(name="granite-smoke", n_layers=3, d_model=128, n_heads=8,
                  n_kv_heads=1, d_ff=256, vocab=512, d_head=16)
# MQA: kv cannot shard -> query groups (48/16) shard over model.
RUNTIME = RuntimeCfg()
SKIP = {}
