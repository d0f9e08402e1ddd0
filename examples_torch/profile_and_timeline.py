"""Observability tour on the GPT-3 5B paper config.

Three artifacts from one pp=8 zero-bubble training scenario:

* ``gpt3_5b_zb_h1.json`` — a Perfetto/Chrome-trace timeline of the
  *simulated* execution: one track per pipeline stage, microbatch slots
  on the compute stream, collective spans annotated with
  algorithm/bytes on the comm stream, warmup/bubble/cooldown filler.
  Open it at https://ui.perfetto.dev (or chrome://tracing).  The export
  reconciles EXACTLY with ``SimResult.step_time`` — per-track span sums
  equal the simulated step time in float arithmetic, not approximately.
* ``generator_profile.json`` — a self-profiling trace of the generator
  pipeline itself (assemble → distribute → instantiate → simulate →
  timeline), captured with ``repro_torch.obs.profiled()``.  The same spans
  stream to any run via ``REPRO_TRACE=1``; ``REPRO_LOG=debug`` narrates
  fallback decisions on stderr.
* a metrics snapshot diff showing what the run cost in cache traffic
  (engine builds/hits/evictions/staleness re-wraps) — the data behind
  ``python -m repro_torch.obs summarize/diff``.

Usage:  PYTHONPATH=src python examples_torch/profile_and_timeline.py
"""
import repro_torch.obs as obs
from repro_torch import Scenario, TPU_V5E
from repro_torch.core import ModelSpec

GPT3_5B = ModelSpec(name="gpt3-5b", n_layers=24, d_model=4096, n_heads=32,
                    n_kv_heads=32, d_ff=16384, vocab=51200, gated_ffn=False)


def main() -> None:
    before = obs.snapshot()
    with obs.profiled() as prof:
        tr = (Scenario(GPT3_5B)
              .train(batch=1, seq=2048)
              .parallel(pp=8, microbatches=16)
              .schedule("zb-h1")
              .trace())
        sim = tr.simulate(TPU_V5E)
        tl = tr.timeline("gpt3_5b_zb_h1.json", TPU_V5E, memory=True)

    print(f"simulated step time: {sim.ms:.1f} ms "
          f"(timeline end {tl.end_time * 1e3:.1f} ms, "
          f"exact match: {tl.end_time == sim.step_time})")
    print(f"timeline: gpt3_5b_zb_h1.json "
          f"({len(tl.events)} spans over {len(tl.processes)} tracks) "
          f"-> open at https://ui.perfetto.dev\n")

    print(tl.utilization().summary())

    print("\ngenerator self-profile (where the *generator* spent time):")
    print(prof.summary())
    prof.export("generator_profile.json")
    print("-> generator_profile.json (same Perfetto format)\n")

    print("cache traffic for this run:")
    print(obs.metrics.format_diff(obs.diff(before, obs.snapshot())))


if __name__ == "__main__":
    main()
