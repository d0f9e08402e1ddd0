"""STAGE core: the paper's Symbolic Tensor Graph generator (own copy of
``repro.core``; sympy + numpy, with the batched evaluator in PyTorch).

Pipeline (paper Fig 3):
  ModelSpec -> build_graph (templates + assembly) -> distribute (tensor-
  level + matcher) -> apply_pipeline (graph-level) -> instantiate
  (symbolic -> numeric) -> {chakra export, memory, costmodel, simulate, dse}.

``dse.sweep(..., backend="batched")`` evaluates whole structure classes on
the card (``core/batched.py``).
"""
from .assemble import (MLASpec, ModelSpec, MoESpec, SSMSpec, bind_env,
                       build_graph, total_layers)
from .chakra import export_ranks, export_stage
from .collectives import ALGORITHMS, CollectiveModel, comm_model
from .compiled import CompiledBackend, CostProgram
from .costmodel import (H100_HGX, H100_HGX_POD, TPU_V5E, TPU_V5E_POD,
                        HardwareProfile)
from .distribute import ParallelCfg, distribute
from .dse import SweepResult
from .graphdist import apply_pipeline
from .instantiate import Workload, instantiate
from .matcher import CommStep, InfeasibleConfigError, match
from .memory import MemoryReport, peak_memory
from .schedules import SCHEDULES, Schedule, build_schedule, inflight_factor
from .simulate import SimResult, simulate
from .stg import Graph, GraphBuilder, add_optimizer, backward
from .symbolic import Env, sym
from .tensor import REPLICATED, STensor, ShardSpec
from .topology import (ClusterTopology, Tier, flat, h100_hgx_pod,
                       tpu_v5e_pod)

__all__ = [
    "MLASpec", "ModelSpec", "MoESpec", "SSMSpec", "bind_env", "build_graph",
    "total_layers", "export_ranks", "export_stage", "CompiledBackend",
    "CostProgram", "H100_HGX", "H100_HGX_POD", "TPU_V5E", "TPU_V5E_POD",
    "HardwareProfile", "ClusterTopology", "Tier", "flat", "h100_hgx_pod",
    "tpu_v5e_pod", "ALGORITHMS", "CollectiveModel", "comm_model",
    "ParallelCfg", "distribute", "SweepResult",
    "apply_pipeline", "Workload", "instantiate", "CommStep",
    "InfeasibleConfigError", "match", "MemoryReport",
    "peak_memory", "SCHEDULES", "Schedule", "build_schedule",
    "inflight_factor", "SimResult", "simulate", "Graph", "GraphBuilder",
    "add_optimizer", "backward", "Env", "sym", "REPLICATED", "STensor",
    "ShardSpec", "generate",
]


def generate(spec: ModelSpec, cfg: ParallelCfg, *, batch: int, seq: int,
             kv_len=None, mode: str = "train", name=None) -> tuple:
    """One-call STAGE pipeline: returns (workload, graph, plan, env).

    .. deprecated::
        Use :class:`repro_torch.Scenario` — same pipeline behind a fluent
        builder, with assembled graphs cached per (spec, mode).  This
        shim routes through it, so the legacy 4-tuple results stay
        bit-identical and old scripts keep reproducing.
    """
    import warnings

    from ..api import Scenario
    warnings.warn("repro_torch.core.generate() is deprecated; use "
                  "repro_torch.Scenario(spec).train(...)/.serve(...).trace()",
                  DeprecationWarning, stacklevel=2)
    tr = Scenario(spec, mode=mode, batch=batch, seq=seq, kv_len=kv_len,
                  cfg=cfg, name=name).trace()
    return tr.workload, tr.graph, tr.plan, tr.env
