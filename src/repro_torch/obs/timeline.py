"""Perfetto/Chrome-trace export of the *simulated* execution
(observability tentpole, piece 1).

:func:`build_timeline` replays one workload through
:func:`repro_torch.core.simulate.simulate` with a
:class:`~repro_torch.core.simulate.TimelineRecorder` attached, so every span
below comes from the **same float arithmetic** that produced
``SimResult.step_time`` — the timeline is a byproduct of the
simulation, not a parallel re-implementation, and the reconciliation
invariant is structural:

* one track (pid) per pipeline stage, with a *scheduling* stream
  (tid 0) of microbatch-expanded slot spans (``fwd``/``bwd``/``bwd_in``
  /``bwd_w`` for gpipe / 1f1b / interleaved / zb-h1), explicit
  ``bubble`` spans (warmup / interior / cooldown / sync) filling every
  idle window, and the optimizer span;
* a *comm* stream (tid 1) of per-collective spans annotated with
  algorithm / tier / bytes from the shared
  :class:`~repro_torch.core.collectives.CollectiveModel`;
* optional memory counters derived from the schedule's in-flight
  activation units, and a resilience track of failure/restore epochs
  (:class:`repro_torch.ft.ReplayEvent`).

Events carry ``(ts, end)`` — never a recomputed duration — so the
scheduling stream of every stage *tiles* ``[0, step_time]`` exactly:
each span starts at the previous span's end and the last span of every
track ends at ``SimResult.step_time`` with float ``==``
(:meth:`Timeline.reconcile`; pinned for all bundled archs × schedules ×
backends by tests/test_timeline.py).

:func:`job_timeline` renders a serving :class:`~repro_torch.core.serving.
JobResult` as pool lanes (prefill pool / decode pool / kv-transfer) and
:class:`UtilizationReport` derives MFU, exposed-comm fraction, and the
per-stage bubble breakdown from the same spans.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from ..core.collectives import comm_model
from ..core.simulate import TimelineRecorder, simulate

__all__ = ["TimelineEvent", "Timeline", "UtilizationReport",
           "build_timeline", "job_timeline", "profile_chrome_trace",
           "validate_chrome_trace"]

SCHED_TID, COMM_TID, DETAIL_TID = 0, 1, 2


@dataclass(frozen=True)
class TimelineEvent:
    """One complete ("X") span.  ``ts``/``end`` are seconds; the JSON
    duration is derived at serialization time only — reconciliation
    always compares the stored endpoints."""
    name: str
    pid: int
    tid: int
    ts: float
    end: float
    cat: str                   # compute | comm | bubble | opt | resilience | pool
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.end - self.ts


class Timeline:
    """An ordered set of spans + track metadata, exportable to
    Perfetto/chrome://tracing JSON unmodified."""

    def __init__(self, events: list, *, processes: dict, threads: dict,
                 counters: list | None = None, step_time: float = 0.0,
                 sim=None, meta: dict | None = None,
                 sched_pids: tuple = ()):
        self.events: list[TimelineEvent] = events
        self.processes = processes           # pid -> name
        self.threads = threads               # (pid, tid) -> name
        self.counters = counters or []       # (pid, name, t, value)
        self.step_time = step_time
        self.sim = sim
        self.meta = meta or {}
        self.sched_pids = sched_pids         # pids under the reconciliation invariant

    # ---- reconciliation --------------------------------------------------
    def track_events(self, pid: int, tid: int = SCHED_TID) -> list:
        evs = [e for e in self.events if e.pid == pid and e.tid == tid]
        evs.sort(key=lambda e: (e.ts, e.end))
        return evs

    def track_end(self, pid: int) -> float:
        evs = self.track_events(pid)
        return evs[-1].end if evs else 0.0

    def track_span_sum(self, pid: int) -> float:
        """Total of the scheduling stream's spans.  The spans tile the
        track (verified by :meth:`reconcile`), so the sum telescopes to
        ``last.end - first.ts`` — exact, with no float re-accumulation."""
        evs = self.track_events(pid)
        if not evs:
            return 0.0
        return evs[-1].end - evs[0].ts

    @property
    def end_time(self) -> float:
        ends = [self.track_end(p) for p in self.sched_pids]
        return max(ends) if ends else 0.0

    def reconcile(self, step_time: Optional[float] = None) -> list:
        """Verify the structural invariant; returns a list of problem
        strings (empty == reconciled).

        Every scheduling track must (a) tile: start at 0, each span
        begin exactly at its predecessor's end, and (b) end exactly
        (float ``==``) at ``step_time``; hence per-track span sums equal
        ``step_time`` by telescoping."""
        target = self.step_time if step_time is None else step_time
        problems = []
        for pid in self.sched_pids:
            evs = self.track_events(pid)
            if not evs:
                problems.append(f"track {pid}: no scheduling spans")
                continue
            if evs[0].ts != 0.0:
                problems.append(f"track {pid}: first span starts at "
                                f"{evs[0].ts!r}, not 0.0")
            for prev, nxt in zip(evs, evs[1:]):
                if nxt.ts != prev.end:
                    problems.append(
                        f"track {pid}: gap/overlap between "
                        f"{prev.name!r}@{prev.end!r} and "
                        f"{nxt.name!r}@{nxt.ts!r}")
                    break
            if evs[-1].end != target:
                problems.append(
                    f"track {pid}: ends at {evs[-1].end!r} != "
                    f"step_time {target!r}")
            if self.track_span_sum(pid) != target:
                problems.append(
                    f"track {pid}: span sum {self.track_span_sum(pid)!r} "
                    f"!= step_time {target!r}")
        return problems

    # ---- utilization -----------------------------------------------------
    def utilization(self) -> "UtilizationReport":
        return UtilizationReport.from_timeline(self)

    # ---- serialization ---------------------------------------------------
    def chrome_trace(self) -> dict:
        """The Chrome-trace JSON object (dict).  ``ts``/``dur`` in
        microseconds, "X" events globally sorted by timestamp, "M"
        metadata naming every process/thread."""
        out = []
        for pid in sorted(self.processes):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": self.processes[pid]}})
            out.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                        "tid": 0, "args": {"sort_index": pid}})
        for (pid, tid) in sorted(self.threads):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": self.threads[(pid, tid)]}})
        xs = []
        for e in self.events:
            ev = {"ph": "X", "name": e.name, "cat": e.cat,
                  "pid": e.pid, "tid": e.tid,
                  "ts": e.ts * 1e6, "dur": (e.end - e.ts) * 1e6}
            if e.args:
                ev["args"] = e.args
            xs.append(ev)
        for (pid, name, t, value) in self.counters:
            xs.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                       "ts": t * 1e6, "args": {"value": value}})
        xs.sort(key=lambda ev: (ev["ts"], ev["pid"], ev["tid"]))
        return {"traceEvents": out + xs, "displayTimeUnit": "ms",
                "otherData": dict(self.meta)}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (f"Timeline({len(self.events)} events, "
                f"{len(self.processes)} tracks, "
                f"step={self.step_time * 1e3:.3f}ms)")


# --------------------------------------------------------------------------
# Simulated-execution timeline
# --------------------------------------------------------------------------

_BUBBLE_NAMES = ("warmup", "bubble", "cooldown", "sync")


def build_timeline(w, hw, *, microbatches=None, recompute=False,
                   schedule=None, vstages=None, algorithms=None,
                   model=None, perturb=None, resilience_events=None,
                   memory=None, detail: str = "comm",
                   label: str = "") -> Timeline:
    """Simulate ``w`` on ``hw`` and return the recorded Timeline.

    Mirrors :func:`repro_torch.core.simulate.simulate`'s keyword surface
    (``microbatches``/``schedule``/… are what-if overrides) and adds:

    * ``resilience_events`` — :class:`repro_torch.ft.ReplayEvent` sequence to
      render as a failure/restore epoch track (wall-clock axis of the
      replayed incidents, NOT the single-step axis of the stage tracks);
    * ``memory`` — ``{stage: MemoryReport}`` to derive memory-over-time
      counters from the schedule's in-flight activation units;
    * ``detail`` — ``"comm"`` (default: per-collective spans on the
      comm stream), ``"all"`` (adds per-op compute spans on tid 2), or
      ``"slots"`` (scheduling stream only).
    """
    cfg = w.cfg
    if model is None:
        model = comm_model(hw, cfg, algorithms)
    rec = TimelineRecorder()
    sim = simulate(w, hw, microbatches=microbatches, recompute=recompute,
                   schedule=schedule, vstages=vstages, algorithms=algorithms,
                   model=model, perturb=perturb, record=rec)
    step = rec.step_time
    nstages = rec.stages

    events: list[TimelineEvent] = []
    processes = {s: f"stage {s}" for s in range(nstages)}
    threads = {}
    counters: list = []
    describe_cache: dict = {}

    def describe(comm: dict) -> dict:
        key = (comm["coll"], comm["axis"], comm["group"])
        d = describe_cache.get(key)
        if d is None:
            d = model.describe(*key)
            describe_cache[key] = d
        return d

    def comm_args(node) -> dict:
        comm = node.comm
        args = {"coll": comm["coll"], "axis": comm["axis"],
                "group": comm["group"], "bytes": comm["size"]}
        args.update(describe(comm))
        return args

    by_stage: dict[int, list] = {s: [] for s in range(nstages)}
    for (s, slot, start, end) in rec.placements:
        by_stage[s].append((slot, start, end))

    interleaved = rec.vstages > 1
    for s in range(nstages):
        threads[(s, SCHED_TID)] = "schedule"
        if detail != "slots":
            threads[(s, COMM_TID)] = "comm"
        if detail == "all":
            threads[(s, DETAIL_TID)] = "compute ops"
        m = rec.multipliers[s] if rec.multipliers else 1.0
        placed = sorted(by_stage[s], key=lambda p: (p[1], p[2]))
        cursor = 0.0
        mem_units = 0.0
        mem_curve: list = []
        mem_rep = memory.get(s) if memory else None
        if mem_rep is not None:
            static = (mem_rep.weights + mem_rep.grads + mem_rep.opt_states
                      + mem_rep.master_params)
            act_unit = mem_rep.peak_activation
            mem_curve.append((0.0, static))
        for (slot, start, end) in placed:
            if start > cursor:
                name = "warmup" if cursor == 0.0 else "bubble"
                events.append(TimelineEvent(name, s, SCHED_TID, cursor,
                                            start, "bubble"))
            if rec.pp == 1:
                # a pp==1 "slot" is one whole microbatch (fwd+bwd fused)
                name = f"mb{slot.mb}"
            else:
                name = f"{slot.kind} mb{slot.mb}"
                if interleaved:
                    name += f" c{slot.vstage}"
            events.append(TimelineEvent(
                name, s, SCHED_TID, start, end, "compute",
                {"kind": slot.kind, "mb": slot.mb, "chunk": slot.vstage}))
            cursor = end
            body = rec.node_events.get((slot.kind, slot.vstage), ())
            if detail != "slots":
                for (node, stream, t0, t1) in body:
                    if stream == "comm":
                        events.append(TimelineEvent(
                            node.name, s, COMM_TID,
                            start + t0 * m, start + t1 * m, "comm",
                            comm_args(node)))
                    elif detail == "all":
                        events.append(TimelineEvent(
                            node.name, s, DETAIL_TID,
                            start + t0 * m, start + t1 * m, "compute",
                            {"kind": node.kind, "flops": node.flops}))
            if mem_rep is not None:
                if rec.pp > 1:
                    if slot.kind == "fwd":
                        mem_units += 1.0 / rec.vstages
                    elif slot.kind in ("bwd", "bwd_in"):
                        mem_units = max(0.0, mem_units - 1.0 / rec.vstages)
                mem_curve.append((end, static + mem_units * act_unit))
        if cursor < rec.makespan:
            events.append(TimelineEvent("cooldown", s, SCHED_TID, cursor,
                                        rec.makespan, "bubble"))
            cursor = rec.makespan
        opt_span = rec.opt_spans.get(s, 0.0)
        # the step-time formula charges the optimizer AFTER the global
        # makespan; the same float sum keeps the argmax track's end
        # identical to SimResult.step_time
        opt_end = rec.makespan + opt_span
        events.append(TimelineEvent("opt", s, SCHED_TID, rec.makespan,
                                    opt_end, "opt"))
        if detail != "slots":
            for (node, stream, t0, t1) in rec.opt_events.get(s, ()):
                if stream == "comm":
                    events.append(TimelineEvent(
                        node.name, s, COMM_TID,
                        rec.makespan + t0 * m, rec.makespan + t1 * m,
                        "comm", comm_args(node)))
        if opt_end != step:
            events.append(TimelineEvent("sync", s, SCHED_TID, opt_end,
                                        step, "bubble"))
        if mem_rep is not None:
            mem_curve.append((step, static))
            for (t, b) in mem_curve:
                counters.append((s, "memory_gb", t, b / 2 ** 30))

    if resilience_events:
        rp = nstages
        processes[rp] = "resilience"
        threads[(rp, 0)] = "epochs"
        for i, ev in enumerate(resilience_events):
            t_fail = getattr(ev, "t_fail", None)
            if t_fail is None:
                t_fail = ev["t_fail"]
                t_restore = ev["t_restore"]
                ckpt = ev.get("ckpt_step", 0)
                domain = ev.get("domain", "")
            else:
                t_restore = ev.t_restore
                ckpt = ev.ckpt_step
                domain = ev.domain
            base = {"phase": "resilience", "epoch": i, "ckpt_step": ckpt,
                    "domain": domain}
            events.append(TimelineEvent(
                f"failure e{i}", rp, 0, t_fail, t_restore, "resilience",
                dict(base, kind="failure", t=t_fail)))
            events.append(TimelineEvent(
                f"restore e{i}", rp, 0, t_restore, t_restore, "resilience",
                dict(base, kind="restore", t=t_restore)))

    meta = {"label": label or getattr(w, "name", ""),
            "schedule": rec.sched_name, "pp": rec.pp,
            "vstages": rec.vstages, "microbatches": rec.microbatches,
            "step_time_s": step, "hw": getattr(hw, "name", str(hw)),
            "kind": "simulated-execution"}
    tl = Timeline(events, processes=processes, threads=threads,
                  counters=counters, step_time=step, sim=sim, meta=meta,
                  sched_pids=tuple(range(nstages)))
    tl.workload = w
    tl.hw = hw
    tl.recorder = rec
    return tl


# --------------------------------------------------------------------------
# Utilization report
# --------------------------------------------------------------------------

@dataclass
class UtilizationReport:
    """Derived per-step utilization: what the scalar summaries hide.

    ``mfu`` is per-pipeline-lane model-FLOP utilization: useful model
    flops (forward+backward+optimizer as instantiated — tp/dp sharding
    already divided into per-node flops; recompute re-runs add time but
    no useful flops) over ``stages × peak_flops × step_time``."""
    step_time: float
    schedule: str
    microbatches: int
    stages: int
    model_flops: float
    peak_flops: float
    mfu: float
    exposed_comm_fraction: float
    overlap_ratio: float
    bubble_fraction: float
    per_stage: list
    memory_over_time: dict

    @classmethod
    def from_timeline(cls, tl: Timeline) -> "UtilizationReport":
        sim = tl.sim
        w = getattr(tl, "workload", None)
        hw = getattr(tl, "hw", None)
        rec: TimelineRecorder = tl.recorder
        step = tl.step_time
        mb = rec.microbatches
        flops = 0.0
        if w is not None:
            for s in range(rec.stages):
                ns = w.stage_nodes(s)
                mb_f = sum(n.flops for n in ns if n.phase in ("fwd", "bwd"))
                opt_f = sum(n.flops for n in ns if n.phase == "opt")
                flops += mb_f * mb + opt_f
        peak = getattr(hw, "peak_flops", 0.0)
        mfu = (flops / (rec.stages * peak * step)
               if peak and step > 0 else 0.0)
        per_stage = []
        mem_curves: dict = {}
        for pid in tl.sched_pids:
            evs = tl.track_events(pid)
            agg = {n: 0.0 for n in _BUBBLE_NAMES}
            busy = opt = 0.0
            for e in evs:
                if e.cat == "bubble":
                    agg[e.name] = agg.get(e.name, 0.0) + e.dur
                elif e.cat == "opt":
                    opt += e.dur
                else:
                    busy += e.dur
            st = sim.stages[pid] if sim and pid < len(sim.stages) else None
            per_stage.append({
                "stage": pid, "busy_s": busy, "opt_s": opt,
                "warmup_s": agg["warmup"], "interior_s": agg["bubble"],
                "cooldown_s": agg["cooldown"], "sync_s": agg["sync"],
                "idle_s": sum(agg.values()),
                "bubble_fraction": (sum(agg.values()) / step
                                    if step > 0 else 0.0),
                "compute_busy_s": (st.compute_busy * mb + st.opt_compute
                                   if st else 0.0),
                "comm_busy_s": (st.comm_busy * mb + st.opt_comm
                                if st else 0.0),
                "exposed_s": (st.exposed_comm * mb + st.opt_exposed
                              if st else 0.0),
            })
        for (pid, name, t, v) in tl.counters:
            mem_curves.setdefault(pid, []).append((t, v))
        return cls(
            step_time=step, schedule=rec.sched_name, microbatches=mb,
            stages=rec.stages, model_flops=flops, peak_flops=peak, mfu=mfu,
            exposed_comm_fraction=(sim.exposed_comm / step
                                   if sim and step > 0 else 0.0),
            overlap_ratio=sim.overlap_ratio if sim else 0.0,
            bubble_fraction=sim.bubble_fraction if sim else 0.0,
            per_stage=per_stage, memory_over_time=mem_curves)

    def summary(self) -> str:
        lines = [
            f"step_time          {self.step_time * 1e3:.3f} ms "
            f"({self.schedule}, M={self.microbatches}, "
            f"pp={self.stages})",
            f"MFU                {self.mfu * 100:.1f}%  "
            f"({self.model_flops:.3e} flops @ {self.peak_flops:.2e}/s "
            f"per lane)",
            f"exposed comm       {self.exposed_comm_fraction * 100:.1f}% "
            f"of step (overlap ratio {self.overlap_ratio * 100:.1f}%)",
            f"bubble fraction    {self.bubble_fraction * 100:.1f}%",
        ]
        if len(self.per_stage) > 1:
            lines.append(f"{'stage':>5} {'busy_ms':>9} {'warmup':>8} "
                         f"{'interior':>9} {'cooldown':>9} {'sync':>8} "
                         f"{'bubble%':>8}")
            for st in self.per_stage:
                lines.append(
                    f"{st['stage']:>5} {st['busy_s'] * 1e3:>9.3f} "
                    f"{st['warmup_s'] * 1e3:>8.3f} "
                    f"{st['interior_s'] * 1e3:>9.3f} "
                    f"{st['cooldown_s'] * 1e3:>9.3f} "
                    f"{st['sync_s'] * 1e3:>8.3f} "
                    f"{st['bubble_fraction'] * 100:>7.1f}%")
        if self.memory_over_time:
            for pid, curve in sorted(self.memory_over_time.items()):
                peak = max(v for _, v in curve)
                lines.append(f"stage {pid} memory   peak {peak:.2f} GB "
                             f"({len(curve)} samples)")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.summary()


# --------------------------------------------------------------------------
# Serving job timeline (pool lanes)
# --------------------------------------------------------------------------

def job_timeline(job, label: str = "") -> Timeline:
    """Pool-lane view of a :class:`~repro_torch.core.serving.JobResult`.

    One track per pool (disaggregated jobs get separate prefill/decode
    lanes plus a kv-transfer lane); each phase is one span over its
    evaluated wall window, annotated with step_first/step_last so KV
    growth is visible.  Lane ends match ``JobResult.total_time`` up to
    float re-association of the phase sum (the exact ``==`` invariant
    is the per-step Trace timeline's; tests pin this one at 1e-9
    relative)."""
    events: list[TimelineEvent] = []
    processes: dict = {}
    threads: dict = {}
    pool_pid: dict = {}

    def pid_of(pool: str) -> int:
        if pool not in pool_pid:
            pool_pid[pool] = len(pool_pid)
            processes[pool_pid[pool]] = f"pool {pool}"
            threads[(pool_pid[pool], 0)] = "phases"
        return pool_pid[pool]

    cursor = 0.0
    transferred = False
    for ph in job.phases:
        if (job.disaggregated and not transferred and ph.mode == "decode"
                and job.kv_transfer_time > 0.0):
            tp = pid_of("kv-transfer")
            events.append(TimelineEvent(
                "kv transfer", tp, 0, cursor, cursor + job.kv_transfer_time,
                "comm", {"coll": "KVTransfer",
                         "bytes": job.kv_transfer_bytes,
                         "seconds": job.kv_transfer_time}))
            cursor += job.kv_transfer_time
            transferred = True
        pid = pid_of(ph.pool)
        end = cursor + ph.time
        events.append(TimelineEvent(
            ph.name, pid, 0, cursor, end, "pool",
            {"mode": ph.mode, "steps": ph.steps,
             "step_first_ms": ph.step_first * 1e3,
             "step_last_ms": ph.step_last * 1e3,
             "world": ph.world, "peak_gb": ph.peak_gb}))
        cursor = end
    meta = {"label": label or job.label, "kind": "serving-job",
            "batch": job.batch, "out_tokens": job.out_tokens,
            "ttft_s": job.ttft, "tpot_s": job.tpot,
            "total_time_s": job.total_time,
            "disaggregated": job.disaggregated,
            "kv_transfer_bytes": job.kv_transfer_bytes}
    tl = Timeline(events, processes=processes, threads=threads,
                  step_time=job.total_time, sim=None, meta=meta,
                  sched_pids=())
    tl.job = job
    tl.lane_end = cursor
    return tl


# --------------------------------------------------------------------------
# Self-profile export (repro_torch.obs.spans)
# --------------------------------------------------------------------------

def profile_chrome_trace(span_events: list) -> dict:
    """Chrome-trace dict for :class:`repro_torch.obs.spans.SpanEvent` records
    (generator self-profiling; same schema as the simulated timelines,
    timestamps re-based to the first span)."""
    if not span_events:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"kind": "self-profile"}}
    t0 = min(e.ts for e in span_events)
    tids = {}
    out = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "repro generator"}}]
    xs = []
    for e in span_events:
        tid = tids.setdefault(e.tid, len(tids))
        ev = {"ph": "X", "name": e.name, "cat": "self-profile",
              "pid": 0, "tid": tid,
              "ts": (e.ts - t0) * 1e6, "dur": e.dur * 1e6}
        if e.args:
            ev["args"] = dict(e.args)
        xs.append(ev)
    for raw, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": f"thread {raw}"}})
    xs.sort(key=lambda ev: (ev["ts"], ev["tid"]))
    return {"traceEvents": out + xs, "displayTimeUnit": "ms",
            "otherData": {"kind": "self-profile"}}


# --------------------------------------------------------------------------
# Schema validation (shared by the obs CLI and repro_torch.analysis --timeline)
# --------------------------------------------------------------------------

_META_NAMES = {"process_name", "process_sort_index", "process_labels",
               "thread_name", "thread_sort_index"}


def validate_chrome_trace(obj) -> list:
    """Structural validation of a Chrome-trace JSON object; returns a
    list of problem strings (empty == loads in Perfetto unmodified).

    Checks: the ``traceEvents`` container, per-event ``ph``, "X" events
    with finite non-negative ``ts``/``dur`` and ``pid``/``tid``, "M"
    metadata names, and global "X" timestamp ordering (this exporter
    always sorts)."""
    problems = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-list traceEvents"]
    last_ts = None
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph is None:
            problems.append(f"event {i}: missing ph")
            continue
        if ph == "M":
            if ev.get("name") not in _META_NAMES:
                problems.append(f"event {i}: unknown metadata name "
                                f"{ev.get('name')!r}")
            continue
        if ph not in ("X", "C", "B", "E", "i", "I"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        for key in ("pid", "tid"):
            if ph in ("X", "C", "B", "E") and not isinstance(
                    ev.get(key), (int, str)):
                problems.append(f"event {i}: missing/invalid {key}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts != ts or ts < 0:
            problems.append(f"event {i}: invalid ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur != dur or dur < 0:
                problems.append(f"event {i}: invalid dur {dur!r}")
            if not isinstance(ev.get("name"), str) or not ev.get("name"):
                problems.append(f"event {i}: missing name")
            if last_ts is not None and ts < last_ts:
                problems.append(f"event {i}: X events not sorted by ts "
                                f"({ts} after {last_ts})")
            last_ts = ts
        if len(problems) > 50:
            problems.append("... (truncated)")
            break
    return problems
