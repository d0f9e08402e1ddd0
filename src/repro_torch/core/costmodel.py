"""Roofline compute + topology-aware communication cost model.

The paper's compute model is "a mixture of lookup table of benchmarked
operators [and] a calibrated roofline model" (§V-C).  Without bench
hardware we use the calibrated-roofline half: per-category MXU/ALU
efficiencies × a compute/memory roofline.  Communication is costed by
:mod:`repro_torch.core.collectives`: profiles carrying a
:class:`~repro_torch.core.topology.ClusterTopology` charge every collective on
the slowest fabric tier its group actually spans (placement-aware,
hierarchical algorithms); profiles without one keep the original flat
α–β ring (the same first-order math ASTRA-sim's analytical backend
uses).  Profiles for the TPU v5e target and an H100 reference (for
paper-table comparisons) are included in both flavors.

``link_bw_axis`` — per-LOGICAL-axis bandwidth overrides keyed on mesh
axis names ("dp", "pp", …) — is DEPRECATED: which fabric an axis crosses
is a property of the cluster topology plus the axis *placement*
(``ParallelCfg.placement``), not of its name.  The field keeps working
(flat model only) but emits a :class:`DeprecationWarning`;
tests/test_topology.py pins the parity shim (a single-tier topology
reproduces the flat model bit-for-bit).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Optional

from .collectives import CollectiveModel, comm_model
from .instantiate import NodeRec
from .topology import ClusterTopology, h100_hgx_pod, tpu_v5e_pod


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float                    # bf16 FLOP/s per chip
    hbm_bw: float                        # bytes/s
    link_bw: float                       # bytes/s per direction, default axis
    link_bw_axis: dict = field(default_factory=dict)   # DEPRECATED override
    link_latency: float = 2.0e-6         # per ring step (s), flat model
    efficiency: dict = field(default_factory=lambda: {
        "GeMM": 0.85, "Attn": 0.70, "ElementWise": 0.90, "Others": 0.90})
    mem_capacity: float = 16 * 2**30     # bytes HBM per chip
    topology: Optional[ClusterTopology] = None   # hierarchical fabric

    def __post_init__(self):
        # warn on NEW uses of the deprecated per-axis override only:
        # dataclasses.replace() what-ifs on the bundled legacy profiles
        # re-run this hook with the bundled dict the user never set
        if self.link_bw_axis and \
                _axis_sig(self.link_bw_axis) not in _BUNDLED_AXIS_SIGS:
            warnings.warn(
                "HardwareProfile.link_bw_axis (per-logical-axis bandwidth "
                "keyed on mesh axis names) is deprecated: attach a "
                "ClusterTopology (hw.with_topology(...)) and place axes "
                "with ParallelCfg.placement instead",
                DeprecationWarning, stacklevel=3)

    def axis_bw(self, axis: str) -> float:
        return self.link_bw_axis.get(axis, self.link_bw)

    def with_topology(self, topology: ClusterTopology) -> "HardwareProfile":
        """This profile costed on a hierarchical fabric (drops the
        deprecated flat per-axis overrides — the topology owns tiering)."""
        return replace(self, topology=topology, link_bw_axis={},
                       link_bw=topology.tiers[0].bandwidth,
                       link_latency=topology.tiers[0].latency)


def _axis_sig(d: dict) -> tuple:
    return tuple(sorted(d.items()))


_BUNDLED_AXIS_SIGS: set = set()


def _legacy_profile(**kw) -> HardwareProfile:
    """Bundled flat profiles predate the topology model; register their
    axis overrides as known so neither import nor later
    ``dataclasses.replace`` what-ifs on them re-warn."""
    _BUNDLED_AXIS_SIGS.add(_axis_sig(kw.get("link_bw_axis", {})))
    return HardwareProfile(**kw)


# TPU v5e: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI (assignment
# constants); the "pod" axis crosses DCI at lower bandwidth.
TPU_V5E = _legacy_profile(
    name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
    link_bw_axis={"pod": 25e9}, mem_capacity=16 * 2**30)

# H100 SXM5 (paper validation cluster): 989 TFLOP/s bf16 dense, 3.35 TB/s
# HBM3, 450 GB/s NVLink within a box, 50 GB/s IB across boxes.
H100_HGX = _legacy_profile(
    name="h100-hgx", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
    link_bw_axis={"dp": 50e9, "pp": 50e9}, mem_capacity=80 * 2**30)

# Topology-aware flavors: same chips, collectives costed on the fabric
# tier their group spans (4 NVLink boxes / 4 ICI slices by default).
H100_HGX_POD = HardwareProfile(
    name="h100-hgx-pod", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
    mem_capacity=80 * 2**30, topology=h100_hgx_pod(4))

TPU_V5E_POD = HardwareProfile(
    name="tpu-v5e-pod", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
    mem_capacity=16 * 2**30, topology=tpu_v5e_pod(4))


def compute_time(n: NodeRec, hw: HardwareProfile) -> float:
    """Roofline: max(flops-limited, HBM-bandwidth-limited)."""
    eff = hw.efficiency.get(n.category, 0.9)
    t_flops = n.flops / (hw.peak_flops * eff) if n.flops else 0.0
    t_mem = n.bytes_accessed / hw.hbm_bw
    return max(t_flops, t_mem)


# per-profile default models for the model-less comm_time/node_time
# loops: keeps the per-(coll, axis, group) lowering cache alive across
# calls instead of rebuilding it per node (keyed by identity — profiles
# are frozen; the strong ref pins the id against reuse)
_DEFAULT_MODELS: dict[int, tuple] = {}


def _default_model(hw: HardwareProfile) -> CollectiveModel:
    hit = _DEFAULT_MODELS.get(id(hw))
    if hit is not None and hit[0] is hw:
        return hit[1]
    model = comm_model(hw)
    if len(_DEFAULT_MODELS) > 16:
        _DEFAULT_MODELS.clear()
    _DEFAULT_MODELS[id(hw)] = (hw, model)
    return model


def comm_time(n: NodeRec, hw: HardwareProfile,
              model: Optional[CollectiveModel] = None) -> float:
    """Collective duration under ``model`` (built from ``hw`` when not
    given: topology-aware if the profile has one — groups then assumed
    innermost-contiguous absent a config — else the legacy flat ring).
    To reproduce exactly what :func:`repro_torch.core.simulate.simulate`
    charges under a non-default axis placement, pass
    ``model=comm_model(hw, workload.cfg)``; the model-less default and
    the simulator agree bit-for-bit on flat (topology-less) profiles."""
    if n.comm is None:
        return 0.0
    if model is None:
        model = _default_model(hw)
    return model.time_of(n.comm)


def node_time(n: NodeRec, hw: HardwareProfile,
              model: Optional[CollectiveModel] = None) -> float:
    return comm_time(n, hw, model) if n.comm is not None \
        else compute_time(n, hw)
