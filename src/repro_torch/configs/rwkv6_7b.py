"""rwkv6-7b [ssm]: 32L d_model=4096 attn-free d_ff=14336 vocab=65536 —
Finch, data-dependent decay; 64 heads x 64 head_dim [arXiv:2404.05892]."""
from ..core import ModelSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=64,
                 n_kv_heads=64, d_ff=14336, vocab=65536, d_head=64,
                 block="rwkv6", rwkv_decay_rank=64)
SMOKE = ModelSpec(name="rwkv6-smoke", n_layers=3, d_model=128, n_heads=4,
                  n_kv_heads=4, d_ff=448, vocab=512, d_head=32,
                  block="rwkv6", rwkv_decay_rank=16)
RUNTIME = RuntimeCfg()
SKIP = {}   # long_500k: O(1) recurrent state, no KV cache at all
