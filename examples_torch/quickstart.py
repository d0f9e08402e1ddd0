"""STAGE quickstart: synthesize a distributed LLM workload in ~15 lines.

    PYTHONPATH=src python examples_torch/quickstart.py
"""
import os
import tempfile

from repro_torch import ModelSpec, Scenario, TPU_V5E

# 1. describe the model (the paper's "target model" input)
spec = ModelSpec(name="demo-1b", n_layers=16, d_model=2048, n_heads=16,
                 n_kv_heads=4, d_ff=8192, vocab=32000)

# 2. describe the scenario: training workload + parallelization strategy
#    (mesh axes are constructed for you — DP x TP with sequence
#    parallelism and ZeRO-1 optimizer sharding)
trace = (Scenario(spec)
         .train(batch=64, seq=2048)
         .parallel(dp=8, tp=4, zero1=True)
         .trace())

# 3. everything downstream is lazy + memoized on the trace
print("op counts per GPU/step:   ", trace.op_counts())
print("collectives per GPU/step: ", trace.comm_counts())
print("comm volume per GPU (MB): ",
      {k: round(v / 1e6, 1) for k, v in trace.comm_volume().items()})

mem = trace.memory()
sim = trace.simulate(TPU_V5E)
print(f"peak memory/GPU: {mem.peak_gb:.2f} GB   "
      f"step time: {sim.ms:.1f} ms   overlap: {sim.overlap_ratio:.0%}")

out = os.path.join(tempfile.gettempdir(), "stage_demo_traces")
n = trace.export_chakra(out, ranks=range(4))
print(f"wrote {n} Chakra-schema rank traces to {out}")

# 4. one-shot design-space exploration: every power-of-two strategy for
#    a 32-chip system, from a single cached symbolic graph
points = Scenario(spec).train(batch=64, seq=2048).sweep(world=32, max_tp=8)
best = points[0]
print(f"best of {len(points)} strategies @ world=32: "
      f"{best.label} ({best.step_ms:.1f} ms, {best.peak_gb:.1f} GB)")
