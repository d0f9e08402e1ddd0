"""Hierarchical cluster topology and axis placement (network co-design).

The paper's co-design loop (§V-C) costs collectives on the *physical*
fabric they cross: NVLink/ICI inside a node is an order of magnitude
faster than the IB/DCI links between nodes, and *where* each parallelism
axis lands on the rank grid decides which fabric its collectives use.
This module models both halves:

* :class:`ClusterTopology` — a tree of :class:`Tier` levels from the
  innermost links outward (chip -> node -> rail/pod), each with its own
  per-link bandwidth, per-hop latency, and grouping degree.  Capacities
  are cumulative degree products; a communicator spanning ``extent``
  consecutive ranks is bottlenecked by the innermost tier whose capacity
  covers it.

* **Placement** — the order in which mesh axes (plus the implicit
  ``"pp"`` pipeline axis) tile the flat rank grid, innermost first.
  An axis placed innermost occupies contiguous ranks (stride 1 — its
  collectives ride the fast tier); each later axis strides over the
  product of the inner degrees.  :func:`axis_span` turns a
  :class:`~repro_torch.core.distribute.ParallelCfg` + axis name into that
  ``(stride, degree)`` pair, which is all the collective models in
  :mod:`repro_torch.core.collectives` need.

Placement lives on ``ParallelCfg.placement`` (default: mesh-dict order
with ``pp`` outermost — exactly the rank decomposition
:func:`repro_torch.core.chakra.rank_coords` always used), so it is sweepable
like any other strategy dimension and changes *time only, never bytes*.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["Tier", "ClusterTopology", "axis_span", "default_placement",
           "normalize_placement", "h100_hgx_pod", "tpu_v5e_pod", "flat"]


@dataclass(frozen=True)
class Tier:
    """One link level of the cluster tree.

    ``degree`` units of the previous (inner) level are joined by links
    of this tier; ``bandwidth`` is bytes/s per direction per link and
    ``latency`` the per-hop (per ring/tree step) latency in seconds.

    ``mtbf`` (optional) is the mean time between failures of ONE unit of
    this tier in seconds — a whole node for the intra-node tier, a rail /
    slice for the inter-node tier.  It feeds the resilience layer
    (:class:`repro_torch.ft.FailureModel`): a unit failure takes down every
    rank the unit hosts.  ``None`` means the tier contributes no failure
    rate of its own (chip-level failures are modeled separately).
    """
    name: str
    degree: int
    bandwidth: float
    latency: float
    mtbf: Optional[float] = None

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"tier {self.name!r}: degree must be >= 1")
        if self.bandwidth <= 0:
            raise ValueError(f"tier {self.name!r}: bandwidth must be > 0")
        if self.latency < 0:
            raise ValueError(f"tier {self.name!r}: latency must be >= 0")
        if self.mtbf is not None and self.mtbf <= 0:
            raise ValueError(f"tier {self.name!r}: mtbf must be > 0 seconds")


@dataclass(frozen=True)
class ClusterTopology:
    """Hierarchical fabric: ``tiers`` ordered innermost -> outermost."""
    name: str
    tiers: tuple[Tier, ...]

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("a ClusterTopology needs at least one tier")
        object.__setattr__(self, "tiers", tuple(self.tiers))

    @property
    def devices(self) -> int:
        n = 1
        for t in self.tiers:
            n *= t.degree
        return n

    def capacities(self) -> tuple[int, ...]:
        """Cumulative device count reachable within each tier."""
        caps, n = [], 1
        for t in self.tiers:
            n *= t.degree
            caps.append(n)
        return tuple(caps)

    def tier_for_extent(self, extent: int) -> Tier:
        """The bottleneck tier for a communicator spanning ``extent``
        consecutive ranks: the innermost tier whose capacity covers the
        span.  Spans beyond the described cluster clamp to the outermost
        tier (the model treats it as unbounded, so oversubscribed sweep
        worlds still cost sanely)."""
        for tier, cap in zip(self.tiers, self.capacities()):
            if cap >= extent:
                return tier
        return self.tiers[-1]

    def inner_split(self, stride: int, group: int) -> tuple[int, int]:
        """Split a communicator (``group`` members ``stride`` apart) at
        the innermost tier boundary: ``(n_inner, n_outer)`` with
        ``n_inner`` members sharing one innermost unit.  Falls back to a
        flat ``(1, group)`` when the group is not aligned to the tier —
        the stride must divide the unit size, or members straddle unit
        boundaries at varying offsets and no uniform two-level split
        exists."""
        cap0 = self.tiers[0].degree
        if stride >= cap0 or group <= 1 or cap0 % stride != 0:
            return 1, group
        n_inner = min(group, cap0 // stride)
        if n_inner <= 1 or group % n_inner != 0:
            return 1, group
        return n_inner, group // n_inner

    def describe(self) -> str:
        return " > ".join(
            f"{t.name}x{t.degree}@{t.bandwidth / 1e9:.0f}GB/s"
            for t in self.tiers)


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------

def default_placement(axes) -> tuple[str, ...]:
    """Mesh-dict order with ``pp`` outermost — the rank decomposition
    the Chakra exporter has always used."""
    return tuple(axes) + ("pp",)


def normalize_placement(order, axes) -> tuple[str, ...]:
    """Project a candidate axis order onto one config's mesh.

    Keeps the listed axes present in ``axes`` (plus ``"pp"``) in their
    given relative order, appends any mesh axes the candidate omitted
    (mesh-dict order), and ensures ``"pp"`` appears (outermost when
    unlisted) — so one sweep-wide candidate list applies cleanly to
    every factorization."""
    names = set(axes) | {"pp"}
    out = [a for a in order if a in names]
    if len(set(out)) != len(out):
        raise ValueError(f"placement {tuple(order)} repeats an axis")
    out += [a for a in axes if a not in out]
    if "pp" not in out:
        out.append("pp")
    return tuple(out)


def axis_span(cfg, axis: str) -> tuple[int, int]:
    """``(stride, degree)`` of ``axis`` on the flat rank grid under
    ``cfg``'s placement (innermost axis has stride 1).  Axes not listed
    in the placement are outermost."""
    sizes = dict(cfg.axes)
    sizes["pp"] = max(1, cfg.pp)
    order = cfg.placement or default_placement(cfg.axes)
    stride = 1
    for a in order:
        if a == axis:
            return stride, sizes.get(a, 1)
        stride *= sizes.get(a, 1)
    return stride, sizes.get(axis, 1)


# --------------------------------------------------------------------------
# Bundled topologies
# --------------------------------------------------------------------------

def h100_hgx_pod(nodes: int = 4, *, nvlink_bw: float = 450e9,
                 ib_bw: float = 50e9, nvlink_lat: float = 1.0e-6,
                 ib_lat: float = 5.0e-6, gpus_per_node: int = 8,
                 node_mtbf: Optional[float] = None,
                 rail_mtbf: Optional[float] = None) -> ClusterTopology:
    """H100 HGX pod: 8-GPU NVLink boxes joined by per-GPU IB rails.

    ``node_mtbf`` / ``rail_mtbf`` (seconds per unit) feed the resilience
    layer: a node failure takes down its 8 GPUs, a rail failure a whole
    node group (see :class:`repro_torch.ft.FailureModel`)."""
    return ClusterTopology(
        name=f"h100-hgx-{nodes}x{gpus_per_node}",
        tiers=(Tier("nvlink", gpus_per_node, nvlink_bw, nvlink_lat,
                    mtbf=node_mtbf),
               Tier("ib", nodes, ib_bw, ib_lat, mtbf=rail_mtbf)))


def tpu_v5e_pod(slices: int = 4, *, ici_bw: float = 50e9,
                dci_bw: float = 25e9, ici_lat: float = 1.0e-6,
                dci_lat: float = 10.0e-6, chips_per_slice: int = 16,
                slice_mtbf: Optional[float] = None,
                dci_mtbf: Optional[float] = None) -> ClusterTopology:
    """TPU v5e multislice: ICI within a slice, DCI between slices.

    ``slice_mtbf`` / ``dci_mtbf`` (seconds per unit) attach failure
    domains for the resilience layer (a slice failure takes down its
    chips, a DCI failure a slice group)."""
    return ClusterTopology(
        name=f"tpu-v5e-{slices}x{chips_per_slice}",
        tiers=(Tier("ici", chips_per_slice, ici_bw, ici_lat,
                    mtbf=slice_mtbf),
               Tier("dci", slices, dci_bw, dci_lat, mtbf=dci_mtbf)))


def flat(devices: int, bandwidth: float, latency: float,
         name: str = "flat") -> ClusterTopology:
    """Single-tier topology: every link identical.  Reproduces the
    legacy ``link_bw``/``link_latency`` flat model exactly (the
    deprecation parity shim in tests/test_topology.py pins this)."""
    return ClusterTopology(name=name,
                           tiers=(Tier("link", devices, bandwidth, latency),))
