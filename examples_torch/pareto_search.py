"""Pareto-front extraction and branch-and-bound config search.

Three search modes ride on top of the same sweep machinery:

    sc.sweep(16)                      # "full": every feasible point, ranked
    sc.sweep(16, search="pareto")     # evaluate all, return the
                                      # (step, peak-mem, effective-step)
                                      # Pareto front only
    sc.sweep(16, search="bnb")        # branch-and-bound: same front,
                                      # most configs never fully evaluated

"bnb" prices every config with a closed-form lower bound (microbatch
count x critical-path floor + optimizer floor, exact memory coordinate)
and only runs the full evaluation when the bound is not already
dominated by an evaluated point — the front is provably identical to
the exhaustive one.

The batched backend accelerates the exhaustive modes: pp=1 points of a
structure class are replayed as one array program on the device, whose
busy-group sums are the ``cost_reduce`` kernel's launches on the card,
instead of one compiled-program call per config.

    PYTHONPATH=src python examples_torch/pareto_search.py               # the card
    PYTHONPATH=src python examples_torch/pareto_search.py --device cpu
"""
import argparse

from repro_torch import ModelSpec, Scenario, TPU_V5E

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="the batched sweep's device: the card unless 'cpu'")
args = ap.parse_args()

spec = ModelSpec(name="demo-5b", n_layers=24, d_model=2048, n_heads=16,
                 n_kv_heads=16, d_ff=8192, vocab=32000)
sc = Scenario(spec).train(batch=128, seq=512)
SPACE = dict(microbatches=(1, 2, 4, 8), schedule=("1f1b", "gpipe"))

front = sc.sweep(16, TPU_V5E, search="pareto", **SPACE)
bnb = sc.sweep(16, TPU_V5E, search="bnb", **SPACE)

print(f"{'strategy':42s} {'step ms':>9s} {'peak GB':>8s}")
for p in front:
    print(f"{p.label:42s} {p.step_ms:9.1f} {p.peak_gb:8.1f}")

assert sorted(p.label for p in front) == sorted(p.label for p in bnb)
assert bnb.visited < 0.25 * bnb.total, (bnb.visited, bnb.total)
print(f"\nexhaustive: {front.evaluated}/{front.total} configs evaluated "
      f"-> {len(front)} on the front")
print(f"bnb:        {bnb.visited}/{bnb.total} configs evaluated "
      f"({100 * bnb.visited / bnb.total:.0f}%) -> identical front")
print(bnb.summary())

# the batched backend turns the pp=1 slice of the same study into a
# handful of structure-class kernel calls (see summary's "batched:")
bat = sc.with_backend("batched").sweep(16, TPU_V5E, max_pp=1,
                                       microbatches=(1, 2, 4, 8),
                                       device=args.device)
print(f"\n{bat.summary()}")
