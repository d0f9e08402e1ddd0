"""Serving timelines: batched generation TTFT/TPOT + disaggregation.

A GPT3-class model serving batched 512-token generations: the phase
program (prefill -> growing-KV decode) evaluates in CLOSED FORM — O(1)
engine evaluations regardless of generation length — and reports
end-to-end serving metrics (TTFT, TPOT, tokens/s, KV footprint).
Then the same job with prefill and decode disaggregated onto separate
pools (paper Table IX / DistServe-style) vs the colocated baseline.

    PYTHONPATH=src python examples_torch/serve_generation.py
"""
from repro_torch import H100_HGX, ModelSpec, Scenario

# GPT3-class 5B (paper Table VIII family)
GPT3 = ModelSpec(name="gpt3-5b", n_layers=24, d_model=4096, n_heads=32,
                 n_kv_heads=32, d_ff=16384, vocab=51200, gated_ffn=False)

BATCH, PROMPT = 16, 1024
sc = Scenario(GPT3).prefill(batch=BATCH, seq=PROMPT).parallel(tp=8)

# ---- TTFT / TPOT curve over the generation length -------------------------
print(f"== {GPT3.name}: batch={BATCH}, prompt={PROMPT}, tp=8 on H100 ==")
print(f"{'out_tokens':>10} {'TTFT ms':>9} {'TPOT ms':>9} {'tok/s':>9} "
      f"{'KV GB':>6} {'evals':>6}")
job512 = sc.generation(out_tokens=512)
for n in (32, 128, 512):
    res = job512.with_out_tokens(n).evaluate(H100_HGX)
    r = res.row()
    print(f"{n:>10} {r['ttft_ms']:>9} {r['tpot_ms']:>9} "
          f"{r['tokens_per_s']:>9} {r['peak_kv_gb']:>6} "
          f"{res.engine_evals['samples']:>6}")

# ---- disaggregated prefill/decode vs colocated ----------------------------
# 16 GPUs total: colocated tp=8 x dp=2 vs an 8+8 split where each pool
# picks its own parallelization; the KV cache handoff is charged at
# 50 GB/s (a NIC-class inter-pool link).
print("\n== 16 GPUs, out_tokens=512: colocated vs disaggregated ==")
colo = (sc.parallel(dp=2, tp=8).generation(out_tokens=512)
        .evaluate(H100_HGX))
print(f"colocated   dp=2,tp=8        : {colo.describe()}")

dis = (sc.generation(out_tokens=512)
       .disaggregate(prefill_pool=dict(tp=8),
                     decode_pool=dict(dp=2, tp=4),
                     kv_transfer=50e9)
       .evaluate(H100_HGX))
print(f"disaggregated 8 prefill + 8 decode: {dis.describe()}")

# let the sweep pick the split and per-pool parallelization (same
# 50 GB/s inter-pool link as above)
pts = (sc.generation(out_tokens=512).with_kv_transfer(50e9)
       .sweep(16, H100_HGX, splits="auto", max_pp=1))
best = pts[0]
print("\nbest split by tokens/s:")
print(f"  {best.split[0]} prefill [{best.prefill_cfg.describe()}] + "
      f"{best.split[1]} decode [{best.decode_cfg.describe()}] -> "
      f"{best.result.describe()}")
