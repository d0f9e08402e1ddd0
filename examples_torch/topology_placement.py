"""Axis placement on an H100 HGX pod: tp-innermost vs dp-innermost.

The same (DP=4, TP=8) GPT-3 5B training configuration is costed on a
4-node H100 pod (8 GPUs/NVLink box, IB rails between boxes) under the
two canonical placements:

* ``tp`` innermost — tensor-parallel groups stay inside a box, so their
  latency-critical AllGather/ReduceScatter traffic rides 450 GB/s
  NVLink while the fat-but-overlappable DP gradient AllReduce crosses
  IB hierarchically (intra-box ReduceScatter, inter-box ring, intra-box
  AllGather).
* ``dp`` innermost — the TP collectives cross 50 GB/s IB every layer;
  this is the classic mis-placement the topology model exists to expose.

Then the placement is swept as a DSE dimension together with the
factorization itself (`placements=` on ``Scenario.sweep``).

Usage:  PYTHONPATH=src python examples_torch/topology_placement.py
"""
from repro_torch import H100_HGX_POD, Scenario
from repro_torch.core import ModelSpec

GPT3_5B = ModelSpec(name="gpt3-5b", n_layers=24, d_model=4096, n_heads=32,
                    n_kv_heads=32, d_ff=16384, vocab=51200, gated_ffn=False)

PLACEMENTS = (("tp", "dp", "pp"), ("dp", "tp", "pp"))


def main() -> None:
    base = (Scenario(GPT3_5B)
            .train(batch=32, seq=2048)
            .parallel(dp=4, tp=8, sp=True, zero1=True)
            .cluster(H100_HGX_POD.topology))
    print(f"{'placement':<16}{'step_ms':>10}{'exposed_ms':>12}"
          f"{'overlap':>9}")
    for order in PLACEMENTS:
        sim = base.placement(*order).trace().simulate(H100_HGX_POD)
        print(f"{'.'.join(order):<16}{sim.ms:>10.1f}"
              f"{sim.exposed_comm * 1e3:>12.1f}{sim.overlap_ratio:>9.1%}")

    print("\nForcing the DP=16 AllReduce onto a flat ring (vs auto "
          "hierarchical — the group spans 4 members/node x 4 nodes):")
    span = (Scenario(GPT3_5B).train(batch=32, seq=2048)
            .parallel(dp=16, tp=2, sp=True)
            .cluster(H100_HGX_POD.topology).placement("tp", "dp", "pp"))
    for label, sc in (("auto (hier_ring)", span),
                      ("flat ring", span.with_algorithm("AllReduce",
                                                        "ring"))):
        sim = sc.trace().simulate(H100_HGX_POD)
        print(f"  {label:<20}{sim.ms:>10.1f} ms "
              f"(exposed {sim.exposed_comm * 1e3:.1f} ms)")

    print("\nPlacement as a DSE dimension (world=32, placements swept):")
    res = (Scenario(GPT3_5B).train(batch=32, seq=2048)
           .cluster(H100_HGX_POD.topology)
           .sweep(32, H100_HGX_POD, max_pp=4,
                  placements=PLACEMENTS))
    for p in res[:6]:
        print(f"  {p.label:<44}{p.step_ms:>9.1f} ms  {p.peak_gb:>6.1f} GB")
    print(f"  ({len(res)} feasible points, {len(res.skipped)} skipped)")


if __name__ == "__main__":
    main()
