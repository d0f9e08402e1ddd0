"""Resilience-aware co-design: checkpoint intervals and goodput DSE.

Step time is not what a training job delivers — failures, checkpoint
writes, and restore downtime deflate it.  This example runs the two
resilience workflows on a GPT-3 5B config over an H100 HGX pod:

1. **Optimal checkpoint interval vs MTBF** — the Young-Daly closed form
   ``I* = sqrt(2 * C * MTBF)`` per per-chip MTBF assumption, with the
   resulting expected goodput, cross-checked against a seeded
   failure-trace replay (the tests pin the two within 2%).

2. **Effective-goodput DSE** — the same sweep ranked two ways.  A
   dp-replicated config can restore from a live peer (no rewind, no
   periodic checkpoint writes), while tp/pp-heavy shardings must rewind
   to storage — so ``rank_by="effective_goodput"`` can flip the winner
   that a pure step-time ranking picks.

Usage:  PYTHONPATH=src python examples_torch/resilience.py
"""
from repro_torch import ModelSpec, Scenario, TPU_V5E
from repro_torch.core.topology import h100_hgx_pod
from repro_torch.ft import CkptTier, ResilienceSpec, replay_goodput, score_point

GPT3_5B = ModelSpec(name="gpt3-5b", n_layers=24, d_model=4096, n_heads=32,
                    n_kv_heads=32, d_ff=16384, vocab=51200, gated_ffn=False)
POD = h100_hgx_pod(4, node_mtbf=150e3)          # 32 GPUs, NVLink boxes
WORLD = POD.devices

base = Scenario(GPT3_5B).train(batch=32, seq=2048).cluster(POD)

# ---- 1. optimal interval vs MTBF -----------------------------------------
sc = base.parallel(dp=2, tp=4, pp=4, microbatches=8, fsdp=True)
tr = sc.trace()
hw = sc._effective_hw(TPU_V5E)
sim, mem = tr.simulate(hw), tr.memory()
print("Young-Daly checkpoint interval vs per-chip MTBF "
      f"({sc.cfg.describe()}, parallel_fs tier):")
print(f"{'chip MTBF':>12s} {'sys MTBF':>10s} {'ckpt C':>8s} {'I*':>9s} "
      f"{'goodput':>8s} {'replayed':>9s}")
for chip_mtbf in (20e3, 50e3, 100e3, 200e3, 500e3):
    spec = ResilienceSpec(mtbf={"chip": chip_mtbf, "nvlink": 300e3},
                          ckpt="parallel_fs", recovery="storage")
    rep = score_point(sc.cfg, sim, mem, spec, hw)
    model = spec.failure_model(POD, WORLD)
    trace = model.sample(300 * rep.system_mtbf, seed=0)
    mc = replay_goodput(trace, rep.interval, rep.ckpt_cost,
                        rep.restore_cost)
    print(f"{chip_mtbf:12.0f} {rep.system_mtbf:10.0f} {rep.ckpt_cost:8.1f} "
          f"{rep.interval:9.1f} {rep.goodput:8.4f} {mc.goodput:9.4f}")

# ---- 2. effective-goodput flips the step-time winner ---------------------
# a slow archival tier + frequent chip failures make the storage-rewind
# path expensive; peer-recoverable (replicated-dp) configs dodge it
TIER = CkptTier("archival", write_bw=5e7, read_bw=5e7, restart_latency=60.0)
res = base.resilience(mtbf={"chip": 30e3}, ckpt=TIER)
plain = res.sweep(WORLD, max_pp=8, microbatches=8)
eff = res.sweep(WORLD, max_pp=8, microbatches=8,
                rank_by="effective_goodput")
print("\nstep-time ranking vs effective-goodput ranking "
      f"({len(plain)} feasible configs):")
print(f"{'strategy':30s} {'step ms':>9s} {'recovery':>9s} {'goodput':>8s} "
      f"{'eff ms':>9s}")
for p in plain[:3]:
    r = p.resilience
    print(f"{p.label:30s} {p.step_ms:9.1f} {r.recovery:>9s} "
          f"{r.goodput:8.4f} {p.effective_step_ms:9.1f}  <= step-time rank")
for p in eff[:3]:
    r = p.resilience
    print(f"{p.label:30s} {p.step_ms:9.1f} {r.recovery:>9s} "
          f"{r.goodput:8.4f} {p.effective_step_ms:9.1f}  <= goodput rank")
if plain[0].label != eff[0].label:
    print(f"\nwinner flips: {plain[0].label} (fastest step) -> "
          f"{eff[0].label} (most delivered work)")
else:
    print(f"\nwinner stable under failures: {plain[0].label}")

# the flip, pinned to a pair: the fastest storage-recovery config beats
# some peer config on raw step time but loses once failures are priced
flip = next(((a, b)
             for a in plain if a.resilience.recovery == "storage"
             for b in plain if b.resilience.recovery == "peer"
             and a.sim.step_time < b.sim.step_time
             and b.effective_step_time < a.effective_step_time), None)
if flip:
    a, b = flip
    print(f"pair flip: {a.label} steps faster ({a.step_ms:.1f} < "
          f"{b.step_ms:.1f} ms) but {b.label} delivers more "
          f"({b.effective_step_ms:.1f} < {a.effective_step_ms:.1f} "
          f"effective ms)")
