"""deepseek-v2-236b [moe+MLA]: 60L d_model=5120 128H MLA kv_lora=512
expert d_ff=1536 vocab=102400, 160 routed top-6 + 2 shared
[arXiv:2405.04434]."""
from ..core import ModelSpec, MoESpec, MLASpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="deepseek-v2-236b", n_layers=60, d_model=5120,
                 n_heads=128, n_kv_heads=128, d_ff=12288, vocab=102400,
                 d_head=128, block="mla",
                 mla=MLASpec(kv_lora=512, q_lora=1536, rope_dim=64,
                             nope_dim=128, v_dim=128),
                 moe=MoESpec(n_experts=160, top_k=6, n_shared=2,
                             d_expert=1536, first_dense=True))
SMOKE = ModelSpec(name="dsv2-smoke", n_layers=3, d_model=128, n_heads=8,
                  n_kv_heads=8, d_ff=256, vocab=512, d_head=16, block="mla",
                  mla=MLASpec(kv_lora=32, q_lora=48, rope_dim=8, nope_dim=16,
                              v_dim=16),
                  moe=MoESpec(n_experts=8, top_k=2, n_shared=2, d_expert=64,
                              first_dense=True))
RUNTIME = RuntimeCfg()
SKIP = {}
