"""Design-space exploration example (paper Fig 8 workflow).

Sweeps every power-of-two (dp, tp, cp, pp) factorization of a 64-chip
system for a 7B-class model and prints the Pareto view STAGE enables.

The whole sweep assembles the symbolic graph exactly once, and the
default **compiled backend** lowers each distributed-graph structure
class once into a lambdified numeric cost program — config points are
replayed as array arithmetic instead of per-op sympy substitution
(~10-30x sweep throughput vs the reference path; see
benchmarks/BENCH_0.json).  Backend selection and knobs:

    Scenario(spec).train(...).sweep(64)                  # compiled (default)
    Scenario(spec).train(...).with_backend("sympy")...   # reference path
    .sweep(64, workers=2, executor="process")            # parallel chunks
    result.skipped                                       # infeasible cfgs + why

    PYTHONPATH=src python examples_torch/dse_sweep.py
"""
from repro_torch import ModelSpec, Scenario, TPU_V5E, compiled_cache_stats, \
    graph_cache_stats

spec = ModelSpec(name="demo-7b", n_layers=32, d_model=4096, n_heads=32,
                 n_kv_heads=8, d_ff=11008, vocab=32000)
pts = Scenario(spec).train(batch=64, seq=2048).sweep(
    64, TPU_V5E, max_tp=16, max_pp=8, max_cp=4, microbatches=4)
print(f"{'strategy':34s} {'step ms':>9s} {'peak GB':>8s} {'overlap':>8s}")
for p in pts[:18]:
    r = p.row()
    marker = " <= best" if p is pts[0] else ""
    print(f"{r['strategy']:34s} {r['step_ms']:9.1f} {r['peak_gb']:8.1f} "
          f"{r['overlap']:8.2f}{marker}")
fit = [p for p in pts if p.peak_gb <= 16]
if fit:
    print(f"\nbest fitting 16GB HBM: {fit[0].label} @ {fit[0].step_ms:.1f} ms")
if pts.skipped:
    print(f"\nskipped {len(pts.skipped)} infeasible configs, e.g. "
          f"{pts.skipped[0].reason}")
cs = compiled_cache_stats()
print(f"\n{len(pts)} points from {graph_cache_stats()['builds']} symbolic "
      f"assembly(ies); {cs['compiles']} compiled structure classes, "
      f"{cs['hits']} numeric replays")
