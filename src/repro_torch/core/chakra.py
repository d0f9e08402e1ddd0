"""Chakra-schema export (paper §IV-B2).

STAGE's default downstream format is the MLCommons Chakra execution
trace schema.  We emit the JSON rendering of the schema: one trace per
rank, nodes with ``COMP_NODE`` / ``COMM_COLL_NODE`` / ``COMM_SEND_NODE``
/ ``COMM_RECV_NODE`` types, data/control dependency lists, and the
attribute records (num_ops, tensor_size, comm_type, comm_size, pg) used
by ASTRA-sim's Chakra feeder.

Per-rank export is a cheap stamping pass over the per-stage
representative (SPMD) records, so writing 32K rank files costs seconds,
not cluster-hours — the paper's Fig 13 claim.  ``decompose_alltoall``
reproduces the NCCL send/recv decomposition used for Kineto alignment
in Table VII.

``expand_microbatches`` additionally unrolls the configured pipeline
schedule (:mod:`repro_torch.core.schedules`): every fwd/bwd (or zero-bubble
``bwd_in``/``bwd_w``) slot of the rank's stage timeline is stamped as a
per-microbatch instance — ids offset by ``mb · stride`` so the
``-uid`` recv-id scheme stays collision-free — chained by control deps
in slot order, so a Chakra feeder replays exactly the chosen schedule
(GPipe vs 1F1B vs interleaved vs ZB-H1) instead of a repeat-annotated
single microbatch.
"""
from __future__ import annotations

import json
import os
import re
from typing import Iterable, Optional

from typing import TYPE_CHECKING

from ..obs.spans import span as _span
from .instantiate import NodeRec, Workload
from .schedules import BWD, BWD_IN, BWD_W, FWD, build_schedule

if TYPE_CHECKING:                           # import-cycle-free type hints
    from .collectives import CollectiveModel

_COMM_TYPE = {
    "AllReduce": "ALL_REDUCE", "AllGather": "ALL_GATHER",
    "ReduceScatter": "REDUCE_SCATTER", "AllToAll": "ALL_TO_ALL",
    "Broadcast": "BROADCAST", "Reduce": "REDUCE",
    "Gather": "GATHER", "Scatter": "SCATTER",
}


def node_to_chakra(n: NodeRec, *, decompose_alltoall: bool = False,
                   comm_model: "CollectiveModel | None" = None) -> list[dict]:
    base = {
        "id": n.uid,
        "name": n.name,
        "data_deps": list(n.deps),
        "ctrl_deps": [],
        "attrs": {"phase": n.phase, "category": n.category,
                  "repeat": n.repeat, **{k: str(v) for k, v in n.tags.items()}},
    }
    if n.comm is None:
        return [{**base, "type": "COMP_NODE",
                 "attrs": {**base["attrs"], "num_ops": n.flops,
                           "tensor_size": n.out_bytes}}]
    coll = n.comm["coll"]
    if comm_model is not None:
        # fabric metadata for topology-aware feeders: selected algorithm,
        # bottleneck tier, and the group's stride on the rank grid
        base["attrs"].update(comm_model.describe(
            coll, n.comm["axis"], n.comm["group"]))
    if coll == "SendRecv":
        size = n.comm["size"]
        return [
            {**base, "id": n.uid, "type": "COMM_SEND_NODE",
             "attrs": {**base["attrs"], "comm_size": size}},
            {**base, "id": -n.uid, "name": n.name + "_recv",
             "type": "COMM_RECV_NODE", "data_deps": [n.uid],
             "attrs": {**base["attrs"], "comm_size": size}},
        ]
    if coll == "AllToAll" and decompose_alltoall:
        # NCCL implements AllToAll as grouped Send/Recv (paper §V-D):
        # each rank sends (g-1) shards of size/g and receives the same.
        g = n.comm["group"]
        size = n.comm["size"]
        out = []
        for j in range(2):  # one send node + one recv node carrying (g-1) msgs
            out.append({**base,
                        "id": n.uid if j == 0 else -n.uid,
                        "name": f"{n.name}_{'send' if j == 0 else 'recv'}",
                        "type": "COMM_SEND_NODE" if j == 0 else "COMM_RECV_NODE",
                        "attrs": {**base["attrs"],
                                  "comm_size": size * (g - 1) / g,
                                  "fanout": g - 1}})
        return out
    return [{**base, "type": "COMM_COLL_NODE",
             "attrs": {**base["attrs"], "comm_type": _COMM_TYPE[coll],
                       "comm_size": n.comm["size"], "pg": n.comm["axis"],
                       "pg_size": n.comm["group"]}}]


def _resilience_nodes(events, base_id: int, tail_id) -> list[dict]:
    """Failure/restore epoch markers as annotated COMP nodes.

    Each incident becomes a (failure, restore) node pair: zero-cost
    compute nodes carrying ``phase="resilience"``, the epoch index, the
    wall-clock times, and the checkpoint step the restore rewinds to —
    feeders that understand them can replay downtime, everything else
    sees two empty compute nodes.  The pairs are control-chained onto
    the end of the step body (failure -> restore -> next failure), so
    the trace stays a DAG with one tail.  Verified by the ``STG4xx``
    rule family in :mod:`repro_torch.analysis`."""
    out: list[dict] = []
    prev = tail_id
    for i, e in enumerate(events):
        ev = e if isinstance(e, dict) else {
            "t_fail": e.t_fail, "t_restore": e.t_restore,
            "ckpt_step": e.ckpt_step, "domain": getattr(e, "domain", "")}
        fid, rid = base_id + 2 * i, base_id + 2 * i + 1
        common = {"phase": "resilience", "epoch": i,
                  "ckpt_step": int(ev.get("ckpt_step", 0)),
                  "domain": str(ev.get("domain", "")),
                  "num_ops": 0, "tensor_size": 0}
        out.append({"id": fid, "name": f"resilience_failure_{i}",
                    "type": "COMP_NODE", "data_deps": [],
                    "ctrl_deps": [prev] if prev is not None else [],
                    "attrs": {**common, "kind": "failure",
                              "t": float(ev["t_fail"])}})
        out.append({"id": rid, "name": f"resilience_restore_{i}",
                    "type": "COMP_NODE", "data_deps": [],
                    "ctrl_deps": [fid],
                    "attrs": {**common, "kind": "restore",
                              "t": float(ev["t_restore"])}})
        prev = rid
    return out


def export_stage(w: Workload, stage: int, *, decompose_alltoall: bool = False,
                 expand_microbatches: bool = False,
                 comm_model: "CollectiveModel | None" = None,
                 resilience_events=None) -> dict:
    if expand_microbatches:
        nodes = _expanded_nodes(w, stage,
                                decompose_alltoall=decompose_alltoall,
                                comm_model=comm_model)
    else:
        nodes = []
        for n in w.stage_nodes(stage):
            nodes.extend(node_to_chakra(n, decompose_alltoall=decompose_alltoall,
                                        comm_model=comm_model))
    # cross-stage producers are satisfied by the recv side of Send/Recv
    # pairs; drop dangling dep ids so each per-rank trace is self-contained
    ids = {nd["id"] for nd in nodes}
    for nd in nodes:
        nd["data_deps"] = [d for d in nd["data_deps"] if d in ids]
    if resilience_events:
        # appended AFTER dep pruning: epoch markers have no data deps and
        # their ids sit past every body id (incl. negated recv ids)
        base = max((abs(nd["id"]) for nd in nodes), default=0) + 1
        tail = nodes[-1]["id"] if nodes else None
        nodes = nodes + _resilience_nodes(resilience_events, base, tail)
    return {"schema": "Chakra-json-v0.0.4", "workload": w.name,
            "stage": stage, "nodes": nodes}


def _expanded_nodes(w: Workload, stage: int, *,
                    decompose_alltoall: bool,
                    comm_model: "CollectiveModel | None" = None) -> list[dict]:
    """Per-microbatch node instances in the rank's schedule-slot order.

    Instance ids are ``uid + mb · stride`` (recv side ``-(uid + mb ·
    stride)``) with ``stride > max uid``, so instances never collide
    with each other or with their negated recv ids.  Data deps stay
    within the same microbatch instance (a microbatch's backward
    consumes its own forward's activations); once-per-step optimizer
    nodes depend on EVERY microbatch instance of their producers (grad
    accumulation).  Each slot's nodes carry a control dep on the last
    node of the previous slot — that chain IS the schedule."""
    cfg = w.cfg
    sched = build_schedule(getattr(cfg, "schedule", "1f1b"), max(1, cfg.pp),
                           cfg.microbatches, getattr(cfg, "vstages", 1))
    stride = max((n.uid for n in w.nodes), default=0) + 1
    mb = sched.microbatches

    by_slot: dict[tuple[str, int], list[NodeRec]] = {}
    for c in w.vstages_of(stage):
        by_slot[(FWD, c)] = w.phase_nodes(stage, "fwd", c)
        bwd = w.phase_nodes(stage, "bwd", c)
        if sched.splits_backward:
            by_slot[(BWD_IN, c)] = [n for n in bwd if not n.wgrad]
            by_slot[(BWD_W, c)] = [n for n in bwd if n.wgrad]
        else:
            by_slot[(BWD, c)] = bwd
    opt_nodes = w.phase_nodes(stage, "opt")
    expanded_uids = {n.uid for recs in by_slot.values() for n in recs}

    out: list[dict] = []
    prev_tail: Optional[int] = None
    for slot in sched.timelines[stage]:
        recs = by_slot.get((slot.kind, slot.vstage))
        if not recs:
            continue
        off = slot.mb * stride
        for n in recs:
            for nd in node_to_chakra(n, decompose_alltoall=decompose_alltoall,
                                     comm_model=comm_model):
                inst = dict(nd)
                inst["id"] = nd["id"] + off if nd["id"] > 0 else nd["id"] - off
                inst["data_deps"] = [d + off if d > 0 else d - off
                                     for d in nd["data_deps"]]
                inst["ctrl_deps"] = [prev_tail] if prev_tail is not None else []
                inst["attrs"] = {**nd["attrs"], "repeat": 1, "mb": slot.mb}
                out.append(inst)
        prev_tail = out[-1]["id"]
    for n in opt_nodes:
        for nd in node_to_chakra(n, decompose_alltoall=decompose_alltoall,
                                 comm_model=comm_model):
            inst = dict(nd)
            deps: list[int] = []
            for d in nd["data_deps"]:
                if d in expanded_uids:       # grads accumulate over all mbs
                    deps.extend(d + k * stride for k in range(mb))
                else:
                    deps.append(d)
            inst["data_deps"] = deps
            inst["ctrl_deps"] = [prev_tail] if prev_tail is not None else []
            out.append(inst)
    return out


def _offset_ids(nodes: list[dict], base: int) -> list[dict]:
    """Shift a phase body's node ids by ``base`` (recv-side negative ids
    shift negatively, preserving the ``-uid`` pairing scheme)."""
    out = []
    for nd in nodes:
        inst = dict(nd)
        inst["id"] = nd["id"] + base if nd["id"] > 0 else nd["id"] - base
        inst["data_deps"] = [d + base if d > 0 else d - base
                             for d in nd["data_deps"]]
        inst["ctrl_deps"] = [c + base if c > 0 else c - base
                             for c in nd.get("ctrl_deps", [])]
        inst["attrs"] = dict(nd["attrs"])
        out.append(inst)
    return out


_STALE_RE = re.compile(r"^rank\d+\.json$")


def _prepare_out_dir(out_dir: str, new_files: Iterable[str],
                     on_stale: str) -> None:
    """Create ``out_dir`` and deal with rank files a previous export left
    behind that this export will NOT overwrite (a re-export at smaller
    world silently mixes two trace sets otherwise).  ``on_stale`` is
    ``"error"`` (default — refuse), ``"clean"`` (delete them) or
    ``"ignore"`` (leave them; the verifier's manifest audit will flag
    them as ``STG308``)."""
    if on_stale not in ("error", "clean", "ignore"):
        raise ValueError(f"on_stale {on_stale!r} not in error|clean|ignore")
    os.makedirs(out_dir, exist_ok=True)
    keep = set(new_files)
    stale = [fn for fn in sorted(os.listdir(out_dir))
             if _STALE_RE.match(fn) and fn not in keep]
    if not stale:
        return
    if on_stale == "error":
        raise ValueError(
            f"{out_dir!r} holds {len(stale)} rank file(s) from a previous "
            f"export that this one will not overwrite (e.g. {stale[0]!r}); "
            f"pass on_stale='clean' to delete them, 'ignore' to keep them")
    if on_stale == "clean":
        for fn in stale:
            os.remove(os.path.join(out_dir, fn))


def _write_manifest(out_dir: str, files: Iterable[str], kind: str,
                    **meta) -> None:
    """Record exactly which files this export emitted — the verifier's
    stale-file audit (``STG308``) keys off this list."""
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"schema": "Chakra-json-v0.0.4-manifest", "export": kind,
                   "files": sorted(files), **meta}, f)


def export_job(workloads, out_dir: str, *,
               ranks: Optional[Iterable[int]] = None,
               kv_transfer_bytes: float = 0.0,
               decompose_alltoall: bool = False,
               comm_model: "CollectiveModel | None" = None,
               on_stale: str = "error") -> int:
    """Stamp a multi-phase *job* timeline as one coherent per-rank trace
    set (the phase-program redesign's export).

    ``workloads`` is the job's phase list in execution order — one
    representative :class:`~repro_torch.core.instantiate.Workload` per phase,
    carrying ``w.meta`` (``phase`` name, ``pool``, ``steps``, and for
    growing-KV decode phases ``kv_start``/``kv_end``).  Within a rank's
    file the phase bodies are chained by *phase-boundary control deps*
    (every source node of phase ``k+1`` gains a ctrl dep on the tail of
    phase ``k``), decode bodies carry ``steps``/``kv_start``/``kv_end``
    attrs (the body repeats once per decode index with the KV length
    advancing across the span), and phases keep their own data deps —
    a downstream simulator replays the whole request timeline from one
    trace.

    Pools partition the global rank space in order of first appearance
    (prefill pool ranks first, then decode pool ranks).  When
    ``kv_transfer_bytes`` > 0 and consecutive phases sit on different
    pools, the boundary is stamped as an explicit KV-cache handoff:
    every source-pool rank ends its pre-boundary stream with a
    ``COMM_SEND_NODE`` (its share of the cache), every destination-pool
    rank starts with the matching ``COMM_RECV_NODE`` — so the transfer
    is visible to the feeder as real communication, not a gap.  A
    ``job.json`` manifest records the pool layout and phase metadata.
    Returns the number of rank files written.

    The emitted file set is recorded in ``manifest.json``; leftover rank
    files from a previous export into the same directory are handled per
    ``on_stale`` (see :func:`_prepare_out_dir`)."""
    pools: dict[str, dict] = {}
    order: list[str] = []
    metas = []
    for w in workloads:
        meta = dict(w.meta or {})
        pool = meta.get("pool", "default")
        metas.append(meta)
        if pool not in pools:
            pools[pool] = {"world": w.cfg.world, "offset": 0}
            order.append(pool)
        elif pools[pool]["world"] != w.cfg.world:
            raise ValueError(
                f"pool {pool!r} hosts phases with different world sizes "
                f"({pools[pool]['world']} vs {w.cfg.world})")
    off = 0
    for name in order:
        pools[name]["offset"] = off
        off += pools[name]["world"]
    total_world = off
    # the (single) cross-pool boundary carries the KV handoff
    boundary = None
    if kv_transfer_bytes > 0:
        for i in range(1, len(workloads)):
            if metas[i].get("pool", "default") != \
                    metas[i - 1].get("pool", "default"):
                boundary = i
                break
    stage_nodes_cache: dict[tuple, list] = {}

    def phase_body(i: int, stage: int) -> list:
        key = (i, stage)
        hit = stage_nodes_cache.get(key)
        if hit is None:
            w = workloads[i]
            hit = export_stage(w, stage,
                               decompose_alltoall=decompose_alltoall,
                               comm_model=comm_model)["nodes"]
            extra = {k: str(v) for k, v in metas[i].items()}
            for nd in hit:
                nd["attrs"].update(extra)
            stage_nodes_cache[key] = hit
        return hit

    count = 0
    rank_list = list(ranks) if ranks is not None else list(range(total_world))
    emitted = [f"rank{r}.json" for r in rank_list] + ["job.json",
                                                      "manifest.json"]
    _prepare_out_dir(out_dir, emitted, on_stale)
    for rank in rank_list:
        if not 0 <= rank < total_world:
            raise ValueError(f"rank {rank} out of range for job world "
                             f"{total_world} (pools {pools})")
        pname = next(p for p in reversed(order)
                     if pools[p]["offset"] <= rank)
        local = rank - pools[pname]["offset"]
        nodes: list[dict] = []
        prev_tail = None
        base = 0
        coords = {}

        def append_body(body: list) -> None:
            nonlocal base, prev_tail
            shifted = _offset_ids(body, base)
            ids = {nd["id"] for nd in shifted}
            for nd in shifted:
                nd["data_deps"] = [d for d in nd["data_deps"] if d in ids]
                if prev_tail is not None and not nd["data_deps"] \
                        and not nd["ctrl_deps"]:
                    nd["ctrl_deps"] = [prev_tail]
            nodes.extend(shifted)
            base = max(abs(nd["id"]) for nd in shifted) + 1
            prev_tail = shifted[-1]["id"]

        for i, w in enumerate(workloads):
            if metas[i].get("pool", "default") != pname:
                continue
            if boundary is not None and i == boundary:
                # destination pool: the handoff lands before this phase
                append_body([{
                    "id": 1, "name": "kv_transfer_recv",
                    "type": "COMM_RECV_NODE", "data_deps": [],
                    "ctrl_deps": [],
                    "attrs": {"phase": "kv_transfer", "pool": pname,
                              "comm_size":
                                  kv_transfer_bytes / w.cfg.world}}])
            coords = rank_coords(local, w.cfg)
            append_body(phase_body(i, coords["pp"]))
            if boundary is not None and i == boundary - 1:
                # source pool: ship this rank's share of the cache
                append_body([{
                    "id": 1, "name": "kv_transfer_send",
                    "type": "COMM_SEND_NODE", "data_deps": [],
                    "ctrl_deps": [],
                    "attrs": {"phase": "kv_transfer", "pool": pname,
                              "comm_size":
                                  kv_transfer_bytes / w.cfg.world}}])
        trace = {"schema": "Chakra-json-v0.0.4",
                 "job": workloads[0].name, "rank": rank, "pool": pname,
                 "coords": coords, "nodes": nodes}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(trace, f)
        count += 1
    with open(os.path.join(out_dir, "job.json"), "w") as f:
        json.dump({"schema": "Chakra-json-v0.0.4-job",
                   "pools": pools, "world": total_world,
                   "kv_transfer_bytes": kv_transfer_bytes,
                   "phases": metas}, f)
    _write_manifest(out_dir, emitted, "job", world=total_world)
    return count


def rank_coords(rank: int, cfg) -> dict:
    """Decompose a flat rank id into (pp stage, per-axis coordinates).

    The decomposition follows ``cfg.placement`` when set (the axis
    listed first varies fastest — it owns contiguous ranks on the
    physical grid, matching how the topology model costs its
    collectives); the default is mesh order with ``pp`` outermost,
    exactly the historical layout.

    Validates that ``rank`` addresses a real device: it must lie in
    ``[0, cfg.world)`` and the residual pipeline coordinate must be a
    valid stage index (``< cfg.pp``) — malformed ids raise instead of
    being silently clamped downstream."""
    world = cfg.world
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for world size {world} "
                         f"(mesh {cfg.axes}, pp={cfg.pp})")
    order = getattr(cfg, "placement", ()) or tuple(cfg.axes) + ("pp",)
    sizes = {**cfg.axes, "pp": max(1, cfg.pp)}
    coords = {}
    r = rank
    for name in order:                         # innermost first
        coords[name] = r % sizes[name]
        r //= sizes[name]
    # defensive: for a consistent cfg this cannot fire (world = pp *
    # prod(axes), so in-range ranks always decompose fully); it guards
    # cfgs whose fields were mutated after construction — for any
    # placement, not just the default pp-outermost order
    if r:
        raise ValueError(
            f"rank {rank} does not decompose over placement {order} "
            f"(mesh {cfg.axes}, pp={cfg.pp}) — cfg mutated after "
            f"construction?")
    return coords


def export_ranks(w: Workload, out_dir: str, ranks: Optional[Iterable[int]] = None,
                 *, decompose_alltoall: bool = False,
                 expand_microbatches: bool = False,
                 comm_model: "CollectiveModel | None" = None,
                 on_stale: str = "error",
                 resilience_events=None,
                 resilience_meta: Optional[dict] = None) -> int:
    """Stamp per-rank Chakra JSON files (rank -> its stage's trace).

    Each stage's node array is serialized exactly ONCE; per rank only the
    small ``rank``/``coords`` tail is formatted and spliced onto the
    pre-serialized body, so writing 32K rank files is dominated by file
    I/O rather than 32K re-serializations of the same node list.

    The emitted file set is recorded in ``manifest.json``; leftover rank
    files from a previous export into the same directory are handled per
    ``on_stale`` (see :func:`_prepare_out_dir`).

    ``resilience_events`` (a sequence of :class:`repro_torch.ft.ReplayEvent`
    or equivalent dicts) stamps failure/restore epoch markers into every
    stage body — failures are job-wide, so every rank sees the same
    epochs — and records the incident count (+ ``resilience_meta``) in
    the manifest, which the ``STG403`` audit cross-checks against the
    stamped nodes."""
    cfg = w.cfg
    world = cfg.world
    rank_list = list(ranks) if ranks is not None else list(range(world))
    emitted = [f"rank{r}.json" for r in rank_list] + ["manifest.json"]
    _prepare_out_dir(out_dir, emitted, on_stale)
    # pre-serialized stage bodies, open at the tail: '{... "nodes": [...]'
    with _span("chakra.serialize_stages", stages=w.stages):
        stage_body = {
            s: json.dumps(export_stage(
                w, s, decompose_alltoall=decompose_alltoall,
                expand_microbatches=expand_microbatches,
                comm_model=comm_model,
                resilience_events=resilience_events))[:-1]
            for s in range(w.stages)}
    count = 0
    for rank in rank_list:
        coords = rank_coords(rank, cfg)
        stage = coords["pp"]
        if stage >= w.stages:
            raise ValueError(
                f"rank {rank} maps to pipeline stage {stage} but the "
                f"workload only has {w.stages} stage(s) — cfg/workload "
                f"mismatch (cfg.pp={cfg.pp})")
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            f.write(stage_body[stage])
            f.write(f', "rank": {rank}, "coords": {json.dumps(coords)}}}')
        count += 1
    meta = {}
    if resilience_events is not None:
        meta["resilience"] = {"events": len(list(resilience_events)),
                              **(resilience_meta or {})}
    _write_manifest(out_dir, emitted, "ranks", world=world,
                    workload=w.name, **meta)
    return count
