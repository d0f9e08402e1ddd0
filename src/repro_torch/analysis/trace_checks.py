"""Chakra trace validation over ``export_ranks`` / ``export_job`` output.

Two granularities:

* :func:`check_trace` — one rank's trace dict (id uniqueness, dep
  resolution, DAG acyclicity, microbatch-expansion consistency,
  send/recv pairing, attr schema).
* :func:`check_trace_dir` — a directory of ``rank*.json`` files: all
  per-rank checks plus the cross-rank properties (SPMD collective-
  sequence agreement per stage group, kv-transfer matching across
  disaggregated pools, manifest/stale-file audit).
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

from .diagnostics import (ATTR_SCHEMA, DUPLICATE_NODE_ID, EMPTY_TRACE_DIR,
                          KV_TRANSFER_ORPHAN, MICROBATCH_INCONSISTENT,
                          RANK_DIVERGENCE, Report, STALE_TRACE_FILE,
                          TRACE_CYCLE, UNPAIRED_SENDRECV, UNRESOLVED_DEP,
                          WARN)
from .resilience_checks import (check_resilience_manifest,
                                check_resilience_nodes)

_NODE_TYPES = ("COMP_NODE", "COMM_COLL_NODE", "COMM_SEND_NODE",
               "COMM_RECV_NODE")
_COMM_TYPES = ("ALL_REDUCE", "ALL_GATHER", "REDUCE_SCATTER", "ALL_TO_ALL",
               "BROADCAST", "REDUCE", "GATHER", "SCATTER")
_RANK_RE = re.compile(r"^rank(\d+)\.json$")
# the tail export_ranks splices onto its pre-serialized stage body: files
# sharing the byte-identical prefix hold the same SPMD node array, so the
# per-rank checks run once per distinct body instead of once per rank
_SPLICE_RE = re.compile(r', "rank": \d+, "coords": (\{[^{}]*\})\}\s*$')


def _is_kv_transfer(nd: dict) -> bool:
    return nd.get("attrs", {}).get("phase") == "kv_transfer"


def check_trace(trace: dict, *, rank: Optional[int] = None,
                name: str = "") -> Report:
    """Per-rank ``STG3xx`` checks on one decoded trace dict."""
    rank = rank if rank is not None else trace.get("rank")
    rep = Report(name=name or f"rank{rank}" if rank is not None else "trace")
    schema = trace.get("schema", "")
    if not str(schema).startswith("Chakra-json"):
        rep.add(ATTR_SCHEMA, f"unknown trace schema {schema!r}",
                rank=rank, severity=WARN)
    nodes = trace.get("nodes")
    if not isinstance(nodes, list):
        rep.add(ATTR_SCHEMA, "trace has no 'nodes' array", rank=rank)
        return rep

    ids: dict[int, dict] = {}
    for nd in nodes:
        _check_node_schema(nd, rank, rep)
        nid = nd.get("id")
        if not isinstance(nid, int):
            continue
        if nid in ids:
            rep.add(DUPLICATE_NODE_ID,
                    f"node id {nid} used by both {ids[nid].get('name')!r} "
                    f"and {nd.get('name')!r}",
                    node=nid, rank=rank,
                    fixit="instance ids must be unique per rank "
                          "(uid + mb*stride scheme)")
        else:
            ids[nid] = nd

    _check_deps(nodes, ids, rank, rep)
    _check_pairing(nodes, ids, rank, rep)
    _check_mb_expansion(nodes, rank, rep)
    check_resilience_nodes(nodes, rank, rep)
    rep.tally("trace_nodes", len(nodes))
    return rep


def check_trace_dir(path: str, *, name: str = "") -> Report:
    """Validate an offline trace directory (the CLI entry point)."""
    rep = Report(name=name or os.path.basename(os.path.normpath(path)) or path)
    if not os.path.isdir(path):
        rep.add(EMPTY_TRACE_DIR, f"{path!r} is not a directory")
        return rep
    rank_files = {}
    for fn in sorted(os.listdir(path)):
        m = _RANK_RE.match(fn)
        if m:
            rank_files[int(m.group(1))] = os.path.join(path, fn)
    if not rank_files:
        rep.add(EMPTY_TRACE_DIR,
                f"no rank*.json files under {path!r}",
                fixit="point the verifier at an export_ranks/export_job "
                      "output directory")
        return rep

    traces, body_of = _read_traces(rank_files, rep)
    checked_bodies: set[int] = set()
    for rank, tr in traces.items():
        gid = body_of.get(rank)
        if gid is not None:
            if gid in checked_bodies:
                continue        # byte-identical spliced body already checked
            checked_bodies.add(gid)
        rep.extend(check_trace(tr, rank=rank))

    _check_manifest(path, rank_files, rep)
    check_resilience_manifest(
        _load_json(os.path.join(path, "manifest.json")), traces, rep)
    job = _load_json(os.path.join(path, "job.json"))
    _check_rank_divergence(traces, rep, body_of)
    if job is not None:
        _check_kv_transfer(traces, job, rep)
    rep.tally("trace_files", len(rank_files))
    return rep


def _read_traces(rank_files: dict, rep: Report) -> tuple[dict, dict]:
    """Load rank traces, deduplicating :func:`export_ranks`'s spliced
    format — every file is ``<stage body>, "rank": N, "coords": {...}}``
    with a byte-identical prefix per stage, so the node array is parsed
    once per stage and shared (rank/coords come from the cheap tail).
    Returns ``(rank -> trace, rank -> body-group id)``; ranks whose file
    does not match the splice pattern are parsed whole and get no group."""
    traces: dict[int, dict] = {}
    body_of: dict[int, int] = {}
    groups: dict[str, int] = {}         # body prefix text -> group id
    parsed: dict[int, dict] = {}        # group id -> parsed body
    for rank, fp in rank_files.items():
        try:
            with open(fp) as f:
                text = f.read()
        except OSError as e:
            rep.add(EMPTY_TRACE_DIR,
                    f"cannot read {os.path.basename(fp)}: {e}", rank=rank)
            continue
        try:
            # the spliced tail is short; don't scan the whole body
            m = _SPLICE_RE.search(text, max(0, len(text) - 256))
            if m is not None:
                prefix = text[:m.start()]
                # the prefix string itself is the group key: exact byte
                # identity (dict hashes once, memcmps on bucket match) —
                # a sampled/hashed key could silently merge a mutated
                # body with its clean siblings and mask a corruption
                gid = groups.get(prefix)
                if gid is None:
                    gid = len(parsed)
                    groups[prefix] = gid
                    parsed[gid] = json.loads(prefix + "}")
                traces[rank] = {**parsed[gid], "rank": rank,
                                "coords": json.loads(m.group(1))}
                body_of[rank] = gid
            else:
                traces[rank] = json.loads(text)
        except json.JSONDecodeError as e:
            rep.add(EMPTY_TRACE_DIR,
                    f"cannot read {os.path.basename(fp)}: {e}", rank=rank)
    return traces, body_of


# --------------------------------------------------------------------------
# per-rank rules
# --------------------------------------------------------------------------

def _check_node_schema(nd: dict, rank, rep: Report) -> None:
    nid = nd.get("id")
    ntype = nd.get("type")
    attrs = nd.get("attrs")
    # fast path: a well-formed COMP_NODE (the overwhelming majority)
    # falls through with two membership tests and one dep scan
    if ntype == "COMP_NODE" and type(nid) is int and type(attrs) is dict \
            and isinstance(attrs.get("num_ops"), (int, float)) \
            and isinstance(attrs.get("tensor_size"), (int, float)):
        for dep_field in ("data_deps", "ctrl_deps"):
            deps = nd.get(dep_field, ())
            if type(deps) is not list \
                    or any(type(d) is not int for d in deps):
                rep.add(ATTR_SCHEMA,
                        f"node {nd.get('name')!r} {dep_field} is not a "
                        f"list of ints: {deps!r}", node=nid, rank=rank)
        return
    if ntype not in _NODE_TYPES:
        rep.add(ATTR_SCHEMA,
                f"node {nd.get('name')!r} has unknown type {ntype!r}",
                node=nid, rank=rank)
        return
    if not isinstance(attrs, dict):
        rep.add(ATTR_SCHEMA, f"node {nd.get('name')!r} has no attrs record",
                node=nid, rank=rank)
        return
    if not isinstance(nid, int):
        rep.add(ATTR_SCHEMA, f"node {nd.get('name')!r} id {nid!r} is not "
                             f"an integer", node=nid, rank=rank)
    for dep_field in ("data_deps", "ctrl_deps"):
        deps = nd.get(dep_field, [])
        if not isinstance(deps, list) \
                or not all(isinstance(d, int) for d in deps):
            rep.add(ATTR_SCHEMA,
                    f"node {nd.get('name')!r} {dep_field} is not a list of "
                    f"ints: {deps!r}", node=nid, rank=rank)
    if ntype == "COMP_NODE":
        for key in ("num_ops", "tensor_size"):
            if not isinstance(attrs.get(key), (int, float)):
                rep.add(ATTR_SCHEMA,
                        f"COMP_NODE {nd.get('name')!r} lacks numeric "
                        f"attrs[{key!r}]", node=nid, rank=rank)
    elif ntype == "COMM_COLL_NODE":
        if attrs.get("comm_type") not in _COMM_TYPES:
            rep.add(ATTR_SCHEMA,
                    f"COMM_COLL_NODE {nd.get('name')!r} has invalid "
                    f"comm_type {attrs.get('comm_type')!r}",
                    node=nid, rank=rank)
        if not isinstance(attrs.get("comm_size"), (int, float)):
            rep.add(ATTR_SCHEMA,
                    f"COMM_COLL_NODE {nd.get('name')!r} lacks numeric "
                    f"attrs['comm_size']", node=nid, rank=rank)
        if "pg" not in attrs:
            rep.add(ATTR_SCHEMA,
                    f"COMM_COLL_NODE {nd.get('name')!r} names no process "
                    f"group (attrs['pg'])", node=nid, rank=rank)
    else:                                   # send / recv
        if not isinstance(attrs.get("comm_size"), (int, float)):
            rep.add(ATTR_SCHEMA,
                    f"{ntype} {nd.get('name')!r} lacks numeric "
                    f"attrs['comm_size']", node=nid, rank=rank)


def _check_deps(nodes: list, ids: dict, rank, rep: Report) -> None:
    """STG302 (edges resolve) + STG303 (combined dep graph is a DAG)."""
    indeg: dict[int, int] = {nid: 0 for nid in ids}
    succs: dict[int, list[int]] = {nid: [] for nid in ids}
    for nd in nodes:
        nid = nd.get("id")
        if not isinstance(nid, int):
            continue
        for dep_field in ("data_deps", "ctrl_deps"):
            for d in nd.get(dep_field, ()):
                if not isinstance(d, int):
                    continue
                if d not in ids:
                    rep.add(UNRESOLVED_DEP,
                            f"node {nd.get('name')!r} (id {nid}) "
                            f"{dep_field} references missing node {d}",
                            node=nid, rank=rank,
                            fixit="per-rank traces must be self-contained; "
                                  "drop cross-rank dep ids at export")
                elif d != nid:
                    succs[d].append(nid)
                    indeg[nid] += 1
    # Kahn peel: whatever survives sits on a cycle
    ready = [nid for nid, k in indeg.items() if k == 0]
    seen = 0
    while ready:
        nid = ready.pop()
        seen += 1
        for j in succs[nid]:
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
    if seen != len(ids):
        cyc = [nid for nid, k in indeg.items() if k > 0]
        sample = ", ".join(f"{i}({ids[i].get('name')})" for i in cyc[:4])
        rep.add(TRACE_CYCLE,
                f"{len(cyc)} node(s) sit on a data/control dependency "
                f"cycle: {sample}{'…' if len(cyc) > 4 else ''}",
                node=cyc[0], rank=rank,
                fixit="control-dep chains must follow slot order; a "
                      "back-edge means the schedule stamping is corrupt")


def _check_pairing(nodes: list, ids: dict, rank, rep: Report) -> None:
    """STG101 within a rank: the ``-uid`` recv-id pairing scheme — every
    send has its recv and vice versa (kv-transfer nodes pair across
    ranks and are audited by :func:`_check_kv_transfer`)."""
    for nd in nodes:
        nid = nd.get("id")
        if not isinstance(nid, int) or _is_kv_transfer(nd):
            continue
        if nd.get("type") == "COMM_SEND_NODE":
            peer = ids.get(-nid)
            if peer is None or peer.get("type") != "COMM_RECV_NODE":
                rep.add(UNPAIRED_SENDRECV,
                        f"send {nd.get('name')!r} (id {nid}) has no "
                        f"matching recv (expected node id {-nid})",
                        node=nid, rank=rank,
                        fixit="a dropped recv deadlocks the peer rank; "
                              "restore the COMM_RECV_NODE")
        elif nd.get("type") == "COMM_RECV_NODE":
            peer = ids.get(-nid)
            if peer is None or peer.get("type") != "COMM_SEND_NODE":
                rep.add(UNPAIRED_SENDRECV,
                        f"recv {nd.get('name')!r} (id {nid}) has no "
                        f"matching send (expected node id {-nid})",
                        node=nid, rank=rank)


def _check_mb_expansion(nodes: list, rank, rep: Report) -> None:
    """STG304: every expanded node name must cover the same microbatch
    set (a missing instance means one microbatch silently skips an op)."""
    mb_sets: dict[str, set[int]] = {}
    for nd in nodes:
        mb = nd.get("attrs", {}).get("mb")
        if isinstance(mb, int):
            mb_sets.setdefault(nd.get("name", "?"), set()).add(mb)
    if not mb_sets:
        return
    full = set()
    for s in mb_sets.values():
        full |= s
    for nm, s in mb_sets.items():
        if s != full:
            missing = sorted(full - s)
            rep.add(MICROBATCH_INCONSISTENT,
                    f"node {nm!r} instantiated for microbatches "
                    f"{sorted(s)} but the trace spans {sorted(full)} "
                    f"(missing {missing})",
                    node=nm, rank=rank,
                    fixit="re-export with expand_microbatches; do not "
                          "hand-prune instances")


# --------------------------------------------------------------------------
# cross-rank rules
# --------------------------------------------------------------------------

def _comm_signature(trace: dict) -> list[tuple]:
    sig = []
    for nd in trace.get("nodes", ()):
        if nd.get("type") in ("COMM_COLL_NODE", "COMM_SEND_NODE",
                              "COMM_RECV_NODE") and not _is_kv_transfer(nd):
            attrs = nd.get("attrs", {})
            sig.append((nd.get("type"), nd.get("name"),
                        attrs.get("comm_type"), attrs.get("pg"),
                        attrs.get("comm_size")))
    return sig


def _group_key(trace: dict) -> tuple:
    """Ranks expected to be SPMD-identical: same pool + pipeline stage."""
    stage = trace.get("stage")
    if stage is None:
        stage = trace.get("coords", {}).get("pp", 0)
    return (trace.get("pool", "default"), stage)


def _check_rank_divergence(traces: dict, rep: Report,
                           body_of: Optional[dict] = None) -> None:
    """STG307: all ranks of one (pool, stage) group must issue the same
    collectives in the same order — the classic SPMD deadlock.  Ranks
    sharing a deduplicated spliced body (``body_of``) are byte-identical
    and compared via their cached signature."""
    body_of = body_of or {}
    sig_cache: dict[int, list] = {}

    def sig(rank: int) -> list:
        gid = body_of.get(rank)
        if gid is None:
            return _comm_signature(traces[rank])
        if gid not in sig_cache:
            sig_cache[gid] = _comm_signature(traces[rank])
        return sig_cache[gid]

    groups: dict[tuple, list[int]] = {}
    for rank, tr in traces.items():
        groups.setdefault(_group_key(tr), []).append(rank)
    for key, ranks in groups.items():
        ranks.sort()
        ref_rank = ranks[0]
        ref = sig(ref_rank)
        for rank in ranks[1:]:
            cur = sig(rank)
            if cur is ref or cur == ref:
                continue
            idx = next((i for i, (a, b) in enumerate(zip(ref, cur))
                        if a != b), min(len(ref), len(cur)))
            a = ref[idx] if idx < len(ref) else "<end>"
            b = cur[idx] if idx < len(cur) else "<end>"
            rep.add(RANK_DIVERGENCE,
                    f"rank {rank} diverges from rank {ref_rank} (group "
                    f"pool={key[0]!r} stage={key[1]}) at collective "
                    f"#{idx}: {b} vs {a} — mismatched/reordered "
                    f"collectives deadlock the group",
                    rank=rank, stage=key[1],
                    fixit="SPMD ranks of one group must be stamped from "
                          "the same representative body")


def _check_kv_transfer(traces: dict, job: dict, rep: Report) -> None:
    """STG305: disaggregated KV handoff — every source-pool rank sends
    exactly once, every destination-pool rank receives exactly once,
    and the shipped bytes balance."""
    kv_bytes = job.get("kv_transfer_bytes", 0.0)
    sends: dict[str, list[tuple[int, float]]] = {}
    recvs: dict[str, list[tuple[int, float]]] = {}
    for rank, tr in traces.items():
        pool = tr.get("pool", "default")
        for nd in tr.get("nodes", ()):
            if not _is_kv_transfer(nd):
                continue
            size = nd.get("attrs", {}).get("comm_size", 0.0)
            if nd.get("type") == "COMM_SEND_NODE":
                sends.setdefault(pool, []).append((rank, size))
            elif nd.get("type") == "COMM_RECV_NODE":
                recvs.setdefault(pool, []).append((rank, size))
    if not kv_bytes:
        if sends or recvs:
            rep.add(KV_TRANSFER_ORPHAN,
                    "trace carries kv-transfer nodes but job.json records "
                    "kv_transfer_bytes == 0")
        return
    if not sends or not recvs:
        rep.add(KV_TRANSFER_ORPHAN,
                f"job declares a {kv_bytes:.3g}-byte KV handoff but the "
                f"traces contain "
                f"{'no sends' if not sends else 'no recvs'}",
                fixit="re-export the job; the pool boundary must stamp "
                      "send/recv pairs")
        return
    pools = job.get("pools", {})
    for side, by_pool, kind in (("send", sends, "source"),
                                ("recv", recvs, "destination")):
        if len(by_pool) > 1:
            rep.add(KV_TRANSFER_ORPHAN,
                    f"kv-transfer {side}s appear in multiple pools "
                    f"{sorted(by_pool)} — the handoff must cross exactly "
                    f"one pool boundary")
        for pool, items in by_pool.items():
            world = pools.get(pool, {}).get("world")
            seen_ranks = [r for r, _ in items]
            if len(set(seen_ranks)) != len(seen_ranks):
                dup = sorted({r for r in seen_ranks
                              if seen_ranks.count(r) > 1})
                rep.add(KV_TRANSFER_ORPHAN,
                        f"rank(s) {dup} stamp more than one kv-transfer "
                        f"{side}", rank=dup[0])
            if world is not None and len(set(seen_ranks)) != world:
                rep.add(KV_TRANSFER_ORPHAN,
                        f"{kind} pool {pool!r} has {len(set(seen_ranks))} "
                        f"kv-transfer {side}(s) for a world of {world} — "
                        f"orphaned ranks would hang at the handoff",
                        fixit="every rank of the pool must participate in "
                              "the KV handoff")
    sent = sum(s for items in sends.values() for _, s in items)
    recvd = sum(s for items in recvs.values() for _, s in items)
    tol = 1e-6 * max(1.0, kv_bytes)
    if abs(sent - recvd) > tol or abs(sent - kv_bytes) > tol:
        rep.add(KV_TRANSFER_ORPHAN,
                f"kv-transfer volume imbalance: {sent:.6g} bytes sent, "
                f"{recvd:.6g} received, job declares {kv_bytes:.6g}")


def _check_manifest(path: str, rank_files: dict, rep: Report) -> None:
    """STG308: with a manifest present, the directory must contain
    exactly the files the export emitted — stale leftovers from a
    previous (larger-world) export silently corrupt downstream runs."""
    manifest = _load_json(os.path.join(path, "manifest.json"))
    if manifest is None:
        return
    listed = set(manifest.get("files", ()))
    for rank, fp in sorted(rank_files.items()):
        fn = os.path.basename(fp)
        if fn not in listed:
            rep.add(STALE_TRACE_FILE,
                    f"{fn} is not in the export manifest — stale leftover "
                    f"from a previous export into this directory",
                    rank=rank,
                    fixit="delete the file or re-export with "
                          "on_stale='clean'")
    for fn in sorted(listed):
        if not os.path.exists(os.path.join(path, fn)):
            rep.add(STALE_TRACE_FILE,
                    f"manifest lists {fn} but the file is missing",
                    fixit="re-export the trace set")


def _load_json(fp: str):
    try:
        with open(fp) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
