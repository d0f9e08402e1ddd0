"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=102400, 64 routed top-6 + 2 shared, fine-grained; first layer dense
[arXiv:2401.06066]."""
from ..core import ModelSpec, MoESpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="deepseek-moe-16b", n_layers=28, d_model=2048,
                 n_heads=16, n_kv_heads=16, d_ff=10944, vocab=102400,
                 d_head=128,
                 moe=MoESpec(n_experts=64, top_k=6, n_shared=2,
                             d_expert=1408, first_dense=True))
SMOKE = ModelSpec(name="dsmoe-smoke", n_layers=3, d_model=128, n_heads=4,
                  n_kv_heads=4, d_ff=256, vocab=512, d_head=32,
                  moe=MoESpec(n_experts=8, top_k=2, n_shared=2, d_expert=64,
                              first_dense=True))
RUNTIME = RuntimeCfg()
SKIP = {}
