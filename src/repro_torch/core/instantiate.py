"""Graph instantiation: symbolic -> numeric conversion (paper §IV-E).

Replaces symbolic shapes with concrete values and produces, per pipeline
stage, a fully numeric workload: one :class:`NodeRec` per executed op
with FLOPs, bytes accessed, communication volume/group, and dependency
edges.  Because every rank within a stage is SPMD-identical (tensor-level
distribution), one representative rank per stage captures the whole
system — this is what makes STAGE's 32K-GPU synthesis cheap (Fig 13):
per-rank export is a stamping pass over the representative record.

This module is the REFERENCE evaluation backend (per-op sympy
substitution).  :mod:`repro_torch.core.compiled` mirrors every cost formula
here operation-for-operation in the same float-arithmetic order so its
numeric replay is bit-identical — if you change how a NodeRec field is
computed, update the compiled kernels too (tests/test_backend_parity.py
enforces the contract).

``NodeRec.comm`` records BYTES only (``size`` per the NCCL/Kineto
volume convention, ``wire`` per the ring algorithm terms) — never time.
Durations are applied downstream by the shared
:class:`~repro_torch.core.collectives.CollectiveModel`, which maps each
``(coll, axis, group)`` onto the fabric tier the group spans under the
config's axis placement.  That split is what keeps Table VII volumes
and both backends' parity invariant under cluster topology and
placement changes (they re-time the same records).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .distribute import ParallelCfg
from .graphdist import PipelinePlan
from .stg import (CAT_COMM, Comm, Graph, Op, SendRecv, Update)
from .symbolic import Env, prod
from .tensor import DTYPE_BYTES


@dataclass
class NodeRec:
    """One numeric node of the instantiated execution graph."""
    uid: int
    name: str
    kind: str                   # op class name
    category: str               # GeMM | Attn | ElementWise | Others | Comm
    phase: str                  # fwd | bwd | opt
    stage: int                  # physical pipeline stage
    flops: float = 0.0
    bytes_accessed: float = 0.0
    out_bytes: float = 0.0
    comm: Optional[dict] = None         # {coll, axis, group, size, wire}
    deps: tuple[int, ...] = ()          # uids of producer nodes (same rank)
    repeat: int = 1                     # executions per training step
    tags: dict = field(default_factory=dict)
    vstage: int = 0             # virtual stage/chunk (== stage unless
                                # the plan interleaves; chunk % pp == stage)
    wgrad: bool = False         # bwd node producing a weight grad (the
                                # deferrable half zero-bubble schedules split)


@dataclass
class Workload:
    """Instantiated distributed workload (all stages, one rank each)."""
    cfg: ParallelCfg
    env: Env
    nodes: list[NodeRec]
    stage_of: dict[int, int]
    name: str = "workload"
    meta: dict = field(default_factory=dict)    # phase-program stamping
    # (phase name / pool / kv span) read by chakra.export_job

    # ---- paper-table style summaries ------------------------------------
    def op_counts(self, stage: int = 0, per: str = "step") -> dict[str, int]:
        """# of executed ops per GPU by category (Table VI)."""
        out: dict[str, int] = {}
        for n in self.nodes:
            if n.stage != stage or n.category == CAT_COMM:
                continue
            out[n.category] = out.get(n.category, 0) + n.repeat
        return out

    def comm_counts(self, stage: int = 0) -> dict[str, int]:
        out: dict[str, int] = {}
        for n in self.nodes:
            if n.stage != stage or n.comm is None:
                continue
            out[n.comm["coll"]] = out.get(n.comm["coll"], 0) + n.repeat
        return out

    def comm_volume(self, stage: int = 0) -> dict[str, float]:
        """Per-GPU communication volume in bytes by collective (Table VII)."""
        out: dict[str, float] = {}
        for n in self.nodes:
            if n.stage != stage or n.comm is None:
                continue
            k = n.comm["coll"]
            out[k] = out.get(k, 0.0) + n.comm["size"] * n.repeat
        return out

    def flops_by_category(self, stage: int = 0) -> dict[str, float]:
        out: dict[str, float] = {}
        for n in self.nodes:
            if n.stage != stage or n.category == CAT_COMM:
                continue
            out[n.category] = out.get(n.category, 0.0) + n.flops * n.repeat
        return out

    def total_flops(self, stage: int = 0) -> float:
        return sum(v for v in self.flops_by_category(stage).values())

    def stage_nodes(self, stage: int) -> list[NodeRec]:
        return [n for n in self.nodes if n.stage == stage]

    def phase_nodes(self, stage: int = 0, phase: str = "fwd",
                    vstage: Optional[int] = None) -> list[NodeRec]:
        """Nodes of one phase on a (virtual) stage, in execution order —
        the per-chunk slot bodies the schedule replay times."""
        return [n for n in self.nodes
                if n.stage == stage and n.phase == phase
                and (vstage is None or n.vstage == vstage)]

    def vstages_of(self, stage: int) -> list[int]:
        """Virtual-stage (chunk) ids hosted by ``stage``, ascending."""
        return sorted({n.vstage for n in self.nodes if n.stage == stage})

    @property
    def stages(self) -> int:
        return max((n.stage for n in self.nodes), default=0) + 1


def instantiate(graph: Graph, cfg: ParallelCfg, env: Env,
                plan: Optional[PipelinePlan] = None,
                name: str = "workload") -> Workload:
    """Ground the distributed STG into a numeric per-stage workload."""
    mesh = cfg.mesh
    stage_of_op = plan.op_stage if plan else {}
    vstage_of_op = plan.op_vstage if plan else {}
    nodes: list[NodeRec] = []
    producer_node: dict[int, int] = {}          # tensor uid -> node uid

    for op in graph.ops:
        stage = stage_of_op.get(op.uid, 0)
        vstage = vstage_of_op.get(op.uid, stage)
        deps = tuple(sorted({producer_node[t.uid] for t in op.ins
                             if t.uid in producer_node}))
        comm = None
        if isinstance(op, Comm):
            comm = {
                "coll": op.coll, "axis": op.axis, "group": mesh.get(op.axis, 1),
                "size": op.comm_bytes(env, mesh),
                "wire": op.wire_bytes(env, mesh),
            }
        elif isinstance(op, SendRecv):
            comm = {
                "coll": "SendRecv", "axis": "pp", "group": 2,
                "size": op.comm_bytes(env, mesh),
                "wire": op.comm_bytes(env, mesh),
            }
        repeat = 1 if op.phase == "opt" else cfg.microbatches
        out_bytes = sum((env.fevaluate(prod(t.local_shape(mesh))))
                        * DTYPE_BYTES[t.dtype] for t in op.outs
                        if t.kind != "index")
        rec = NodeRec(
            uid=op.uid, name=op.name, kind=op.kind, category=op.category,
            phase=op.phase, stage=stage,
            flops=op.flops(env, mesh),
            bytes_accessed=op.bytes_accessed(env, mesh),
            out_bytes=out_bytes,
            comm=comm, deps=deps, repeat=repeat, tags=dict(op.tags),
            vstage=vstage,
            wgrad=any(t.kind == "grad" for t in op.outs),
        )
        nodes.append(rec)
        for t in op.outs:
            producer_node[t.uid] = op.uid
    return Workload(cfg=cfg, env=env, nodes=nodes, stage_of=stage_of_op, name=name)
