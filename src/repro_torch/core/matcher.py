"""Collective Communication Matcher (paper §IV-D2, Fig 6, Table IV).

Given a tensor whose *producer* distribution differs from what its
*consumer* requires, conceptually reconstruct the full tensor (**Pull**:
Duplicated→NoComm, Partition→Gather, PartialSum→Reduce) and redistribute
it (**Push**: Duplicated→Broadcast, Partition→Scatter) through a virtual
head node, then pattern-match each Pull×Push pair per mesh axis to the
cheapest real collective:

=================  ==================  =========================
Pull (producer)    Push (consumer)     matched collective
=================  ==================  =========================
NoComm (dup)       Broadcast (dup)     — nothing —
NoComm (dup)       Scatter (part d)    Slice*  (local, no comm)
Gather (part d)    Broadcast (dup)     AllGather(axis, d)
Gather (part d1)   Scatter (part d2)   d1==d2: nothing
                                       d1!=d2: AllToAll(axis, d1→d2)
Reduce (partial)   Broadcast (dup)     AllReduce(axis)
Reduce (partial)   Scatter (part d)    ReduceScatter(axis, d)
=================  ==================  =========================

Multi-axis mismatches chain per-axis steps — reductions first, then
re-partitions, then local slices — which yields exactly the composites
in Table IV (``ReduceScatter + AllToAll``, ``AllReduce + AllGather``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

from .stg import Comm, GraphBuilder, SliceLike
from .tensor import ShardSpec, STensor


@dataclass(frozen=True)
class CommStep:
    coll: str                  # AllReduce | AllGather | ReduceScatter | AllToAll | Slice
    axis: str
    dim: Optional[int] = None        # source partition dim (AG/RS/A2A/Slice target)
    dim_dst: Optional[int] = None    # destination dim for AllToAll


class InfeasibleConfigError(ValueError):
    """A parallelization config cannot be realized for this graph.

    Raised (directly or via :class:`MatchError`) when the pipeline hits a
    structural impossibility for the requested factorization; DSE sweeps
    catch exactly this type and record the config as skipped-with-reason
    instead of silently dropping it."""


class MatchError(InfeasibleConfigError):
    pass


def match(produced: ShardSpec, desired: ShardSpec) -> list[CommStep]:
    """Plan the collective chain converting ``produced`` -> ``desired``."""
    steps: list[CommStep] = []
    axes = sorted(set(produced.all_axes) | set(desired.all_axes))

    # Phase 1 — resolve PartialSums (the Pull 'Reduce' side).
    for a in axes:
        if produced.state_of_axis(a) != "partial":
            continue
        want = desired.state_of_axis(a)
        if want == "partial":
            continue                       # pass through untouched
        if want == "dup":
            steps.append(CommStep("AllReduce", a))
            produced = produced.drop_axis(a)
        else:                              # partial -> part(d): ReduceScatter
            d = desired.dim_of_axis(a)
            steps.append(CommStep("ReduceScatter", a, dim=d))
            produced = produced.drop_axis(a).with_partition(d, a)
    # Phase 2 — re-partitions (Gather×Scatter matches).
    for a in axes:
        st = produced.state_of_axis(a)
        want = desired.state_of_axis(a)
        if want == "partial" and st != "partial":
            raise MatchError(f"cannot synthesize PartialSum over {a} "
                             f"({produced} -> {desired}); Push-PartialSum is unused (paper §IV-D2)")
        if st == "part":
            d1 = produced.dim_of_axis(a)
            if want == "part":
                d2 = desired.dim_of_axis(a)
                if d1 != d2:
                    steps.append(CommStep("AllToAll", a, dim=d1, dim_dst=d2))
                    produced = produced.drop_axis(a).with_partition(d2, a)
            elif want == "dup":
                steps.append(CommStep("AllGather", a, dim=d1))
                produced = produced.drop_axis(a)
    # Phase 3 — local slices (Pull NoComm × Push Scatter).
    for a in axes:
        if produced.state_of_axis(a) == "dup" and desired.state_of_axis(a) == "part":
            d = desired.dim_of_axis(a)
            steps.append(CommStep("Slice", a, dim=d))
            produced = produced.with_partition(d, a)
    assert _canon(produced) == _canon(desired), \
        f"matcher failed: {produced} != {desired}"
    return steps


@functools.lru_cache(maxsize=4096)
def _canon(spec: ShardSpec) -> ShardSpec:
    # hot in distribution (every _fix compares canon forms); ShardSpec is
    # frozen/hashable and the distinct-spec population is small
    return ShardSpec.make({d: tuple(sorted(spec.axes_of_dim(d)))
                           for d, _ in spec.partition},
                          tuple(sorted(spec.partial)))


def _apply_step(spec: ShardSpec, step: CommStep) -> ShardSpec:
    if step.coll == "AllReduce":
        return spec.drop_axis(step.axis)
    if step.coll == "ReduceScatter":
        return spec.drop_axis(step.axis).with_partition(step.dim, step.axis)
    if step.coll == "AllGather":
        return spec.drop_axis(step.axis)
    if step.coll == "AllToAll":
        return spec.drop_axis(step.axis).with_partition(step.dim_dst, step.axis)
    if step.coll == "Slice":
        return spec.with_partition(step.dim, step.axis)
    raise MatchError(step.coll)


def insert_comms(b: GraphBuilder, t: STensor, desired: ShardSpec, *,
                 phase: str = "fwd", tags=None) -> STensor:
    """Materialize the matched chain as Comm/Slice ops; return final tensor."""
    if _canon(t.spec) == _canon(desired):
        return t
    cur = t
    for step in match(t.spec, desired):
        new_spec = _apply_step(cur.spec, step)
        if step.coll == "Slice":
            op = SliceLike(b._unique(f"{t.name}_slice"), cur, cur.shape,
                           phase=phase, tags=tags)
            op.out.spec = new_spec
            op._matcher = True
            b.add_op(op)
            cur = op.out
            continue
        out = STensor(b._unique(f"{t.name}_{step.coll.lower()}"), cur.shape,
                      cur.dtype, cur.kind if cur.kind == "grad" else "act", new_spec)
        op = Comm(out.name, step.coll, cur, out, step.axis, dim=step.dim,
                  dim_dst=step.dim_dst, phase=phase, tags=tags)
        b.add_op(op)
        cur = out
    # exact (non-canonicalized) desired spec on the final tensor
    cur.spec = desired
    return cur
