"""Graph-level workload distributor — pipeline parallelism (paper §IV-D3).

Unlike tensor-level distribution (each device holds tensor shards and
collaborates on a single operator), graph-level distribution assigns
whole *subgraphs* to device groups.  Following the paper, stages are cut
by the rule-based even-layer split, and every tensor edge crossing a
stage boundary becomes a Send/Recv pair.

Interleaved schedules add a second level: with ``vstages`` virtual
stages (Megatron "model chunks") the layer range is cut into
``pp * vstages`` chunks and chunk ``c`` executes on physical stage
``c % pp`` — so each device hosts ``vstages`` non-contiguous layer
spans and every chunk boundary is a cross-device P2P.  ``op_stage``
always maps to the *physical* stage (what memory/Chakra rank export
need); ``op_vstage`` carries the chunk id the scheduler replays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .stg import Graph, Op, SendRecv


@dataclass
class PipelinePlan:
    pp: int
    n_layers: int
    vstages: int = 1
    op_stage: dict[int, int] = field(default_factory=dict)     # uid -> stage
    op_vstage: dict[int, int] = field(default_factory=dict)    # uid -> chunk
    sendrecvs: list[SendRecv] = field(default_factory=list)

    @property
    def chunks(self) -> int:
        return self.pp * self.vstages

    def stage_of(self, op: Op) -> int:
        return self.op_stage[op.uid]

    def vstage_of(self, op: Op) -> int:
        return self.op_vstage.get(op.uid, self.op_stage[op.uid])


def _stage_for_tags(tags: dict, pp: int, n_layers: int) -> int:
    layer = tags.get("layer")
    if layer is None:
        mod = tags.get("module", "")
        if mod in ("embed", "input"):
            return 0
        return pp - 1          # head / loss / untagged tail ops
    if layer < 0:
        return 0
    if layer >= n_layers:
        return pp - 1
    return min(pp - 1, layer * pp // max(1, n_layers))


def apply_pipeline(graph: Graph, pp: int, n_layers: int, *,
                   vstages: int = 1) -> PipelinePlan:
    """Assign (virtual) stages and splice Send/Recv ops on cross-chunk
    edges (in place)."""
    vstages = max(1, vstages) if pp > 1 else 1
    plan = PipelinePlan(pp=pp, n_layers=n_layers, vstages=vstages)
    if pp <= 1:
        for op in graph.ops:
            plan.op_stage[op.uid] = 0
            plan.op_vstage[op.uid] = 0
        return plan

    chunks = pp * vstages
    producer_chunk: dict[int, int] = {}        # tensor uid -> chunk
    for t in graph.inputs:
        producer_chunk[t.uid] = -1             # inputs available everywhere
    for t in graph.weights:
        producer_chunk[t.uid] = -1             # weights live on their stage

    new_ops: list[Op] = []
    moved: dict[tuple[int, int], object] = {}  # (tensor uid, dst chunk) -> tensor
    for op in graph.ops:
        c = _stage_for_tags(op.tags, chunks, n_layers)
        s = c % pp
        for i, t in enumerate(op.ins):
            cp = producer_chunk.get(t.uid, -1)
            if cp in (-1, c):
                continue
            key = (t.uid, c)
            if key not in moved:
                sr = SendRecv(f"{t.name}_pp{cp}to{c}", t, cp, c,
                              phase=op.phase, tags=dict(op.tags))
                new_ops.append(sr)
                plan.op_stage[sr.uid] = s      # recv side executes on dst
                plan.op_vstage[sr.uid] = c
                plan.sendrecvs.append(sr)
                producer_chunk[sr.out.uid] = c
                moved[key] = sr.out
            op.ins[i] = moved[key]             # type: ignore[assignment]
        new_ops.append(op)
        plan.op_stage[op.uid] = s
        plan.op_vstage[op.uid] = c
        for t in op.outs:
            producer_chunk[t.uid] = c
    graph.ops = new_ops
    return plan
