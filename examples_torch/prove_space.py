"""Certify an entire design space symbolically — no sweeping.

A GPT3-5B-class model at world=1024 with swept microbatches, schedules
and axis placements spans ~63k parallelization configs.  Evaluating
them point-by-point takes minutes even on the compiled backend (hours
on the sympy path).  ``Scenario.prove`` instead collapses the space
onto its *degree lattice* (a few hundred points — guards and lowered
tables depend only on axis degrees) and proves the STG6xx invariants
per structure class:

* STG601 — distributed FLOPs == single-device FLOPs x an exact
  replication monomial, as a symbolic identity in (dp, tp, pp, cp, mb);
* STG602 — collective wire-byte polynomials match the ring-term
  invariant at every group size the space reaches;
* STG603/604 — divisibility guards partition the space (every config
  matches exactly one structure class) and reproduce under a fresh
  distribution trace;
* STG605 — the branch-and-bound step floor never exceeds the true
  step-time polynomial, certifying ``search="bnb"`` exactness;
* STG606 — peak memory is monotone along mesh degrees, licensing
  certificate-driven pruning before any evaluation.

Run: PYTHONPATH=src python examples_torch/prove_space.py
"""
import itertools
import time

from repro_torch import ModelSpec, Scenario

SPEC = ModelSpec(name="gpt3-5b", n_layers=24, d_model=4096, n_heads=32,
                 n_kv_heads=32, d_ff=16384, vocab=50257)
SPACE = dict(
    microbatches=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
    schedule=("gpipe", "1f1b", "interleaved", "zb-h1"),
    placements=list(itertools.permutations(("tp", "dp", "pp"))),
)
WORLD = 1024


def main() -> None:
    sc = Scenario(SPEC).train(batch=2048, seq=2048)

    t0 = time.perf_counter()
    cert = sc.prove(WORLD, **SPACE)
    cold = time.perf_counter() - t0
    print(f"prove[cold] {cold:6.2f}s  {cert.summary()}")
    assert cert.ok, cert.report.render()

    # the engine keeps its structure classes — re-proving (e.g. after
    # editing the sweep bounds) only re-checks the algebra
    t0 = time.perf_counter()
    cert = sc.prove(WORLD, retrace=False, **SPACE)
    warm = time.perf_counter() - t0
    print(f"prove[warm] {warm:6.2f}s  (retrace=False: guard re-trace "
          f"skipped)")

    # what certification bought: sweep one thin slice of the space on
    # the (already warm) compiled backend and extrapolate the
    # point-by-point cost to all of it
    t0 = time.perf_counter()
    slice_res = sc.sweep(WORLD, search="full",
                         microbatches=(1,), schedule=("1f1b",))
    per_cfg = (time.perf_counter() - t0) / max(1, slice_res.evaluated or
                                               len(slice_res.points))
    est = per_cfg * cert.configs
    print(f"vs sweeping: ~{per_cfg * 1e3:.1f} ms/config x "
          f"{cert.configs} configs ≈ {est / 60:.0f} min point-by-point")

    print(f"\ncertificate: {len(cert.classes)} structure class(es) over "
          f"{cert.lattice_points} lattice point(s)")
    for c in cert.classes[:6]:
        print(f"  {c.label:30s} flop={c.flop_conserved} "
              f"comm={c.comm_conserved} guards={c.guards_faithful} "
              f"bound={c.bound_sound} mem={c.mem_monotone}")
    if len(cert.classes) > 6:
        print(f"  ... and {len(cert.classes) - 6} more, all certified")

    # the same certificates ride along a search: prove=True attaches
    # them to the SweepResult and lets branch_and_bound prune
    # provably-dominated cells before evaluating their memory
    res = sc.sweep(64, search="bnb", prove=True,
                   microbatches=(1, 2, 4, 8), schedule=("1f1b", "gpipe"))
    print(f"\nsweep(64, search='bnb', prove=True): {res.summary()}")


if __name__ == "__main__":
    main()
