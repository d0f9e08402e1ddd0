"""Compare pipeline schedules on the GPT-3 5B paper config.

Runs the same pp=8 training scenario (the paper's Table V pipeline cell)
under all four supported schedules and prints the bubble fraction /
step-time / activation-memory trade-off:

* ``gpipe``       — all-forward-then-all-backward; worst memory.
* ``1f1b``        — the Megatron default; bubble equals GPipe's but only
  ``min(M, pp - s)`` microbatches stay in flight.
* ``interleaved`` — virtual stages cut the bubble ~1/vstages at the cost
  of more in-flight chunks and extra P2P.
* ``zb-h1``       — zero-bubble H1: the weight-grad half of backward
  backfills pipeline idle; 1F1B's memory with the smallest bubble.

Usage:  PYTHONPATH=src python examples_torch/pipeline_schedules.py
"""
from repro_torch import Scenario, TPU_V5E
from repro_torch.core import ModelSpec

GPT3_5B = ModelSpec(name="gpt3-5b", n_layers=24, d_model=4096, n_heads=32,
                    n_kv_heads=32, d_ff=16384, vocab=51200, gated_ffn=False)

SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2), ("zb-h1", 1))


def main() -> None:
    base = (Scenario(GPT3_5B)
            .train(batch=1, seq=2048)               # micro-batch shape
            .parallel(pp=8, microbatches=16))
    print(f"{'schedule':<16}{'step_ms':>10}{'bubble':>9}"
          f"{'inflight@0':>12}{'peak_gb@0':>11}")
    for name, vstages in SCHEDULES:
        tr = base.schedule(name, vstages=vstages).trace()
        sim = tr.simulate(TPU_V5E)
        mem = tr.memory(stage=0, master_fp32=False)
        label = name if vstages == 1 else f"{name}(v{vstages})"
        print(f"{label:<16}{sim.ms:>10.1f}{sim.bubble_fraction:>9.1%}"
              f"{mem.inflight_factor:>12.1f}{mem.peak_gb:>11.2f}")
    print("\nSweeping the schedule as a DSE dimension (world=8):")
    res = (Scenario(GPT3_5B).train(batch=8, seq=2048)
           .sweep(8, microbatches=8, max_tp=4,
                  schedule=("1f1b", "interleaved", "zb-h1"), vstages=2))
    for p in res[:5]:
        print(f"  {p.label:<40}{p.step_ms:>9.1f} ms  {p.peak_gb:>6.1f} GB")
    print(f"  ({len(res)} feasible points, {len(res.skipped)} skipped)")


if __name__ == "__main__":
    main()
