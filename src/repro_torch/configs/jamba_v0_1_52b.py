"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attn 7:1 (attn at slot 4 of each 8), MoE 16e top-2
every 2nd layer [arXiv:2403.19887]."""
from ..core import ModelSpec, MoESpec, SSMSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
                 n_kv_heads=8, d_ff=14336, vocab=65536, d_head=128,
                 ssm=SSMSpec(d_state=16, expand=2, dt_rank=256),
                 moe=MoESpec(n_experts=16, top_k=2, n_shared=0,
                             d_expert=14336, every=2),
                 attn_every=8, attn_offset=4)
SMOKE = ModelSpec(name="jamba-smoke", n_layers=8, d_model=128, n_heads=8,
                  n_kv_heads=2, d_ff=256, vocab=512, d_head=16,
                  ssm=SSMSpec(d_state=8, expand=2, dt_rank=8),
                  moe=MoESpec(n_experts=4, top_k=2, n_shared=0, d_expert=256,
                              every=2),
                  attn_every=8, attn_offset=4)
RUNTIME = RuntimeCfg()
SKIP = {}   # long_500k: Mamba layers O(1) state; 1-in-8 attn holds the cache
