"""Distributed communication checks over instantiated workloads.

The workload is the per-stage SPMD representative (one rank per
pipeline stage), so cross-rank properties come in two layers: what can
be proven on the representative (pairing, group metadata, volume
invariants — this module) and what must be compared across stamped
rank files (collective-sequence divergence — ``trace_checks``).
"""
from __future__ import annotations

from ..core.instantiate import NodeRec, Workload
from ..core.stg import COLL_KINDS
from .diagnostics import (BAD_COMM_METADATA, COLLECTIVE_MISMATCH, Report,
                          UNPAIRED_SENDRECV, VOLUME_VIOLATION)

_KNOWN_COLLS = set(COLL_KINDS) | {"SendRecv"}

# wire_bytes / comm_bytes ratio pinned by the ring-algorithm terms in
# :meth:`repro_torch.core.stg.Comm.wire_bytes` — the Table VII invariant the
# collective model re-times but never re-derives
_SHARD_COLLS = ("AllGather", "ReduceScatter", "AllToAll", "Gather",
                "Scatter", "Broadcast", "Reduce")
_REL_TOL = 1e-6


def _expected_wire(coll: str, size: float, group: int) -> float | None:
    if coll == "SendRecv" or coll in ("Send", "Recv"):
        return size
    if group <= 1:
        return 0.0
    if coll == "AllReduce":
        return size * 2 * (group - 1) / group
    if coll in _SHARD_COLLS:
        return size * (group - 1) / group
    return None


def check_comm(w: Workload, *, name: str = "") -> Report:
    """Run the ``STG1xx`` comm rules over one workload."""
    rep = Report(name=name or w.name)
    mesh = w.cfg.mesh
    by_uid: dict[int, NodeRec] = {n.uid: n for n in w.nodes}
    consumers: dict[int, list[NodeRec]] = {}
    for n in w.nodes:
        for d in n.deps:
            consumers.setdefault(d, []).append(n)

    comm_nodes = [n for n in w.nodes if n.comm is not None]
    group_of_axis: dict[str, tuple[int, int]] = {}   # axis -> (group, uid)
    for n in comm_nodes:
        c = n.comm
        coll, axis, group = c.get("coll"), c.get("axis"), c.get("group")
        size, wire = c.get("size"), c.get("wire")

        # ---- STG104: metadata sanity ------------------------------------
        if coll not in _KNOWN_COLLS:
            rep.add(BAD_COMM_METADATA,
                    f"node {n.name!r} carries unknown collective "
                    f"{coll!r}", node=n.uid, stage=n.stage, phase=n.phase)
            continue
        if not isinstance(group, int) or group < 1:
            rep.add(BAD_COMM_METADATA,
                    f"node {n.name!r} ({coll}) has invalid group size "
                    f"{group!r}", node=n.uid, stage=n.stage, phase=n.phase)
            continue
        if size is None or size < 0 or wire is None or wire < 0:
            rep.add(BAD_COMM_METADATA,
                    f"node {n.name!r} ({coll}) has negative/missing "
                    f"volume (size={size!r}, wire={wire!r})",
                    node=n.uid, stage=n.stage, phase=n.phase)
            continue

        if coll == "SendRecv":
            _check_sendrecv(n, by_uid, consumers, w, rep)
        else:
            # ---- STG102: group consistency per mesh axis ----------------
            expected = mesh.get(axis)
            if expected is None:
                rep.add(COLLECTIVE_MISMATCH,
                        f"node {n.name!r} ({coll}) runs on mesh axis "
                        f"{axis!r} which the config does not define "
                        f"(mesh {mesh})",
                        node=n.uid, stage=n.stage, phase=n.phase,
                        fixit="add the axis to ParallelCfg.axes or retarget "
                              "the collective")
            elif group != expected:
                rep.add(COLLECTIVE_MISMATCH,
                        f"node {n.name!r} ({coll}) declares group size "
                        f"{group} on axis {axis!r} but the mesh degree is "
                        f"{expected} — participants would disagree on the "
                        f"group and deadlock",
                        node=n.uid, stage=n.stage, phase=n.phase)
            seen = group_of_axis.get(axis)
            if seen is None:
                group_of_axis[axis] = (group, n.uid)
            elif seen[0] != group:
                rep.add(COLLECTIVE_MISMATCH,
                        f"axis {axis!r} carries collectives with differing "
                        f"group sizes ({seen[0]} at node {seen[1]}, "
                        f"{group} at node {n.uid})",
                        node=n.uid, stage=n.stage, phase=n.phase)

        # ---- STG103: volume conservation --------------------------------
        want = _expected_wire(coll, size, group)
        if want is not None:
            tol = _REL_TOL * max(1.0, abs(want), abs(wire))
            if abs(wire - want) > tol:
                rep.add(VOLUME_VIOLATION,
                        f"node {n.name!r} ({coll}, group {group}): wire "
                        f"bytes {wire:.6g} != {want:.6g} implied by its "
                        f"{size:.6g}-byte buffer — bytes in/out of the "
                        f"group no longer balance",
                        node=n.uid, stage=n.stage, phase=n.phase,
                        fixit="recompute comm['wire'] with "
                              "Comm.wire_bytes; do not edit volumes "
                              "independently")
    rep.tally("comm_checks", len(comm_nodes))
    return rep


def _check_sendrecv(n: NodeRec, by_uid: dict, consumers: dict,
                    w: Workload, rep: Report) -> None:
    """STG101: every send has exactly one matching recv on the peer.

    On the representative, a SendRecv record executes on the
    *destination* stage; its producer dependency lives on the source
    stage and its output must be consumed on the destination stage.  A
    record with no producer is a recv whose send was dropped; a record
    whose output nobody consumes is a send whose recv was dropped."""
    producers = [by_uid[d] for d in n.deps if d in by_uid]
    if not producers:
        rep.add(UNPAIRED_SENDRECV,
                f"SendRecv {n.name!r} has no producer — the receive side "
                f"waits on a send that never happens",
                node=n.uid, stage=n.stage, phase=n.phase,
                fixit="restore the producing op on the source stage")
    dst_consumers = [c for c in consumers.get(n.uid, ())
                     if c.stage == n.stage]
    if not dst_consumers:
        rep.add(UNPAIRED_SENDRECV,
                f"SendRecv {n.name!r} output is consumed by nothing on "
                f"stage {n.stage} — the sent tensor is dropped (orphan "
                f"send)",
                node=n.uid, stage=n.stage, phase=n.phase,
                fixit="wire the received tensor into the destination "
                      "stage's ops or remove the transfer")
