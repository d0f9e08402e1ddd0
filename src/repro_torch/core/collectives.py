"""Per-collective algorithm cost models on a hierarchical topology.

Every collective in a STAGE workload is costed by :class:`CollectiveModel`
— ONE shared entry point used by the event-driven replay in
:mod:`repro_torch.core.simulate` (which both the sympy reference and the
compiled numeric backend feed, so backend parity holds by construction)
and by :func:`repro_torch.core.costmodel.comm_time`.

Two regimes:

* **Legacy flat** (no :class:`~repro_torch.core.topology.ClusterTopology` on
  the profile): the original single-tier α–β ring —
  ``wire/bw + steps·latency`` with the per-axis bandwidth override.
  The lowering reproduces the pre-topology inline math bit-for-bit.

* **Topology-aware**: the communicator's ``(stride, degree)`` span on
  the rank grid (from ``ParallelCfg.placement``) picks the fabric tiers
  it actually crosses, and a per-collective algorithm is lowered to a
  linear-in-bytes record evaluated per node:

  ========================  =================================================
  ``ring``                  flat ring at the bottleneck (outermost crossed)
                            tier; ``(g-1)`` steps, ``2(g-1)`` for AllReduce
  ``hier_ring``             two-level AllReduce: intra-unit ReduceScatter,
                            inter-unit ring AllReduce on ``size/n1`` shards,
                            intra-unit AllGather (NCCL/Charon hierarchical)
  ``halving_doubling``      recursive halving-doubling AllReduce:
                            ring volume, ``2·log2(g)`` latency steps
  ``tree``                  binomial reduce+broadcast: ``2·ceil(log2 g)``
                            sequential full-size hops (latency-optimal,
                            bandwidth-poor — small-message override)
  ``pairwise``              AllToAll: each rank ships ``size·(g-1)/g``
                            total, split between the intra-unit tier
                            (``n1-1`` peers) and the bottleneck tier
                            (``g-n1`` peers), one hop latency per peer
  ``p2p``                   SendRecv: ONE hop of the tier the pipeline
                            edge crosses (not a ring step)
  ========================  =================================================

Algorithm selection is automatic and structural (AllReduce goes
hierarchical exactly when its group spans an inner-tier boundary both
ways); :meth:`CollectiveModel.with_algorithm` overrides it per
collective.  Topologies change *time only*: message/wire byte volumes
stay whatever the distributor emitted (Table VII is invariant).
"""
from __future__ import annotations

import math
from typing import Optional

from .topology import ClusterTopology, axis_span

__all__ = ["CollectiveModel", "comm_model", "ALGORITHMS", "valid_algorithms"]

ALGORITHMS = ("ring", "hier_ring", "halving_doubling", "tree", "pairwise",
              "p2p")

# records produced by the lowering:
#   ("zero",)                -> 0.0
#   ("wire", bw, lat_total)  -> wire / bw + lat_total     (legacy-exact form)
#   ("size", a, b)           -> size * a + b


def valid_algorithms(coll: str) -> tuple[str, ...]:
    if coll == "AllReduce":
        return ("ring", "hier_ring", "halving_doubling", "tree")
    if coll == "AllToAll":
        return ("pairwise", "ring")
    if coll == "SendRecv":
        return ("p2p",)
    # AllGather / ReduceScatter / Broadcast / Reduce / Gather / Scatter
    return ("ring", "halving_doubling")


class _FlatCfg:
    """Stand-in when no ParallelCfg is available (profile-only callers):
    every group is assumed innermost-contiguous (stride 1)."""
    axes: dict = {}
    pp: int = 1
    placement: tuple = ()


class CollectiveModel:
    """Maps ``NodeRec.comm`` records to durations; caches one lowered
    record per ``(coll, axis, group)`` (the hot replay loop then does a
    dict hit + one multiply-add per collective node)."""

    def __init__(self, topology: Optional[ClusterTopology] = None, *,
                 cfg=None, link_bw: float = 0.0,
                 link_bw_axis: Optional[dict] = None,
                 link_latency: float = 0.0,
                 algorithms: Optional[dict] = None):
        self.topology = topology
        self.cfg = cfg if cfg is not None else _FlatCfg()
        self.link_bw = link_bw
        self.link_bw_axis = dict(link_bw_axis or {})
        self.link_latency = link_latency
        self.algorithms = dict(algorithms or {})
        for coll, algo in self.algorithms.items():
            if algo not in valid_algorithms(coll):
                raise ValueError(
                    f"algorithm {algo!r} not valid for {coll} "
                    f"(choose from {valid_algorithms(coll)})")
        if self.algorithms and topology is None:
            # the legacy flat model has exactly one algorithm per
            # collective; accepting an override here would silently
            # cost it as the flat ring — make the no-op loud instead
            raise ValueError(
                "collective algorithm overrides require a ClusterTopology "
                "(attach one with hw.with_topology(...) or "
                "Scenario.cluster(...))")
        self._cache: dict[tuple, tuple] = {}

    def with_algorithm(self, coll: str, algo: str) -> "CollectiveModel":
        """A copy forcing ``coll`` onto ``algo`` (overriding selection)."""
        algos = dict(self.algorithms)
        algos[coll] = algo
        return CollectiveModel(self.topology, cfg=self.cfg,
                               link_bw=self.link_bw,
                               link_bw_axis=self.link_bw_axis,
                               link_latency=self.link_latency,
                               algorithms=algos)

    # ---- evaluation ------------------------------------------------------
    def time_of(self, comm: dict) -> float:
        """Duration of one collective node (seconds)."""
        g = int(comm["group"])
        if g <= 1:
            return 0.0
        key = (comm["coll"], comm["axis"], g)
        rec = self._cache.get(key)
        if rec is None:
            rec = self._lower(*key)
            self._cache[key] = rec
        kind = rec[0]
        if kind == "wire":
            return comm["wire"] / rec[1] + rec[2]
        if kind == "size":
            return comm["size"] * rec[1] + rec[2]
        return 0.0

    def describe(self, coll: str, axis: str, group: int) -> dict:
        """Chakra-stamping metadata: selected algorithm + fabric span."""
        g = int(group)
        if g <= 1 or self.topology is None:
            return {}
        stride, span = self._span(coll, axis, g)
        tier = self.topology.tier_for_extent(span)
        return {"algorithm": self._algo(coll, axis, g),
                "tier": tier.name, "pg_stride": stride}

    def _span(self, coll: str, axis: str, g: int) -> tuple[int, int]:
        """(stride, rank-grid extent) of the communicator.

        Collective groups span ``stride·g`` (their group IS the axis).
        SendRecv records carry ``group=2`` but the pipeline axis hosts
        ``degree`` stages whose adjacent-stage hops sit at different
        offsets; the per-stage representative record is charged the
        SLOWEST hop, i.e. the tier covering the whole axis span (a
        straddling middle hop crosses it even when one hop fits the
        inner tier)."""
        stride, adeg = axis_span(self.cfg, axis)
        if coll == "SendRecv":
            return stride, stride * max(adeg, g)
        return stride, stride * g

    # ---- lowering --------------------------------------------------------
    def _algo(self, coll: str, axis: str, g: int) -> str:
        """The EFFECTIVE algorithm — overrides that degenerate on this
        group (hier_ring without two levels) resolve to what actually
        runs, so :meth:`describe` and :meth:`time_of` always agree."""
        algo = self.algorithms.get(coll)
        if algo is None:
            if self.topology is None:
                return "ring"
            if coll == "SendRecv":
                algo = "p2p"
            elif coll == "AllToAll":
                algo = "pairwise"
            elif coll == "AllReduce":
                algo = "hier_ring"
            else:
                algo = "ring"
        if algo == "hier_ring":
            stride, _ = axis_span(self.cfg, axis)
            n1, n2 = self.topology.inner_split(stride, g)
            if n1 <= 1 or n2 <= 1:
                return "ring"
        return algo

    def _lower(self, coll: str, axis: str, g: int) -> tuple:
        topo = self.topology
        if topo is None:
            # legacy single-tier α–β ring: identical float math to the
            # pre-topology inline model (steps·lat folded once)
            bw = self.link_bw_axis.get(axis, self.link_bw)
            if coll == "SendRecv":
                steps = 1
            else:
                steps = (g - 1) if coll != "AllReduce" else 2 * (g - 1)
            return ("wire", bw, steps * self.link_latency)

        stride, span = self._span(coll, axis, g)
        t_out = topo.tier_for_extent(span)
        n1, n2 = topo.inner_split(stride, g)
        t_in = topo.tier_for_extent(stride * n1)
        algo = self._algo(coll, axis, g)

        if algo == "p2p":
            # one hop of the tier a (stride-separated) pipeline edge
            # crosses — NOT a ring step (wire == size for SendRecv)
            return ("wire", t_out.bandwidth, t_out.latency)
        if algo == "pairwise":
            if n1 == g:
                # whole group inside one unit: collapses to the legacy
                # wire form (bit-identical to the flat single-tier model)
                return ("wire", t_in.bandwidth, (g - 1) * t_in.latency)
            # size/g to each peer: n1-1 intra peers, g-n1 remote peers
            a = ((n1 - 1) / (g * t_in.bandwidth)
                 + (g - n1) / (g * t_out.bandwidth))
            b = (n1 - 1) * t_in.latency + (g - n1) * t_out.latency
            return ("size", a, b)
        if algo == "hier_ring":
            # _algo already degraded degenerate groups to "ring"
            # intra RS + inter ring AR on size/n1 shards + intra AG
            a = (2.0 * (n1 - 1) / (n1 * t_in.bandwidth)
                 + 2.0 * (n2 - 1) / (n1 * n2 * t_out.bandwidth))
            b = (2 * (n1 - 1) * t_in.latency
                 + 2 * (n2 - 1) * t_out.latency)
            return ("size", a, b)
        if algo == "halving_doubling":
            rounds = max(1, math.ceil(math.log2(g)))
            if coll == "AllReduce":
                return ("size", 2.0 * (g - 1) / (g * t_out.bandwidth),
                        2 * rounds * t_out.latency)
            # AG/RS recursive doubling: ring volume, log2 latency steps
            return ("wire", t_out.bandwidth, rounds * t_out.latency)
        if algo == "tree":
            rounds = max(1, math.ceil(math.log2(g)))
            return ("size", 2.0 * rounds / t_out.bandwidth,
                    2 * rounds * t_out.latency)
        # ring at the bottleneck tier
        steps = (g - 1) if coll != "AllReduce" else 2 * (g - 1)
        return ("wire", t_out.bandwidth, steps * t_out.latency)


def comm_model(hw, cfg=None, algorithms: Optional[dict] = None
               ) -> CollectiveModel:
    """Build the collective model for a profile + parallel config.

    With ``hw.topology`` set, collectives are costed tier-aware on the
    placement from ``cfg`` (innermost-contiguous when ``cfg`` is None);
    otherwise the legacy flat ring over ``link_bw``/``link_bw_axis``/
    ``link_latency`` is reproduced exactly."""
    return CollectiveModel(getattr(hw, "topology", None), cfg=cfg,
                           link_bw=hw.link_bw,
                           link_bw_axis=hw.link_bw_axis,
                           link_latency=hw.link_latency,
                           algorithms=algorithms)
