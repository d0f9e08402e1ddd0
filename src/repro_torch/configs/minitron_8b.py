"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron [arXiv:2407.14679]; squared-relu-style
(non-gated) FFN."""
from ..core import ModelSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="minitron-8b", n_layers=32, d_model=4096, n_heads=32,
                 n_kv_heads=8, d_ff=16384, vocab=256000, d_head=128,
                 gated_ffn=False)
SMOKE = ModelSpec(name="minitron-smoke", n_layers=3, d_model=128, n_heads=8,
                  n_kv_heads=2, d_ff=256, vocab=512, d_head=16,
                  gated_ffn=False)
RUNTIME = RuntimeCfg()
SKIP = {}
