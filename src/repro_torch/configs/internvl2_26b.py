"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend STUB (precomputed patch embeddings,
256 vision tokens) + InternLM2 backbone [arXiv:2404.16821].

vocab=92553 is not 16-divisible: the embedding/LM-head stay replicated
over the model axis (data/FSDP-sharded instead) — noted in DESIGN.md."""
from ..core import ModelSpec
from ..models.common import RuntimeCfg

SPEC = ModelSpec(name="internvl2-26b", n_layers=48, d_model=6144, n_heads=48,
                 n_kv_heads=8, d_ff=16384, vocab=92553, d_head=128,
                 vision_seq=256)
SMOKE = ModelSpec(name="internvl-smoke", n_layers=3, d_model=128, n_heads=8,
                  n_kv_heads=2, d_ff=256, vocab=509, d_head=16, vision_seq=8)
RUNTIME = RuntimeCfg()
SKIP = {}
