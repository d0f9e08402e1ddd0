"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap [arXiv:2408.00118]."""
from ..core import ModelSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
                 n_kv_heads=16, d_ff=36864, vocab=256000, d_head=128,
                 softcap=True, attn_softcap=50.0, final_softcap=30.0,
                 window=4096, window_pattern="alternate")
SMOKE = ModelSpec(name="gemma2-smoke", n_layers=4, d_model=128, n_heads=8,
                  n_kv_heads=4, d_ff=320, vocab=512, d_head=16, softcap=True,
                  attn_softcap=50.0, final_softcap=30.0, window=16,
                  window_pattern="alternate")
RUNTIME = RuntimeCfg()
SKIP = {}   # long_500k allowed: half the layers are 4096-window local
