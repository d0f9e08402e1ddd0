"""whisper-medium [audio]: enc-dec 24L+24L d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — conv frontend STUB: inputs are precomputed frame
embeddings [arXiv:2212.04356]."""
from ..core import ModelSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="whisper-medium", n_layers=24, d_model=1024, n_heads=16,
                 n_kv_heads=16, d_ff=4096, vocab=51865, d_head=64,
                 gated_ffn=False, encoder_layers=24, enc_seq=1500)
SMOKE = ModelSpec(name="whisper-smoke", n_layers=2, d_model=128, n_heads=8,
                  n_kv_heads=8, d_ff=256, vocab=512, d_head=16,
                  gated_ffn=False, encoder_layers=2, enc_seq=30)
RUNTIME = RuntimeCfg()
SKIP = {}
