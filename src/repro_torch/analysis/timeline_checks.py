"""Static checks over exported observability timelines (``STG5xx``).

:func:`check_timeline` audits a Perfetto/Chrome-trace JSON object (or a
live :class:`repro_torch.obs.Timeline`) produced by ``Trace.timeline`` /
``Job.timeline`` / the span profiler:

* **Schema** (``STG501``) — every event a well-formed Chrome-trace
  record (:func:`repro_torch.obs.timeline.validate_chrome_trace`).
* **Tiling** (``STG502``/``STG503``) — for simulated-execution
  timelines, each stage's scheduling stream must start at 0, tile
  without gaps or overlaps, and end at the recorded step time.  The
  live :class:`~repro_torch.obs.Timeline` holds seconds and reconciles with
  float ``==``; the saved JSON holds microsecond floats (``ts * 1e6``,
  ``dur = (end - ts) * 1e6``), so the JSON-level audit allows a
  relative tolerance of 1e-9 of the step instead of exact equality.
* **Comm annotations** (``STG504``) — every ``cat="comm"`` span carries
  the collective args (``coll``/``axis``/``group``/``bytes``) the
  downstream consumers key on.
* **Resilience track** (``STG505``) — failure/restore epoch spans
  numbered 0..n-1 in time order with ``t_restore >= t_fail``.

Like every pass in this package the audit is pure traversal — no
simulation, no sympy."""
from __future__ import annotations

import json
import math
import os

from .diagnostics import (Report, TIMELINE_COMM_ATTRS,
                          TIMELINE_RESILIENCE_TRACK, TIMELINE_SCHEMA,
                          TIMELINE_STEP_MISMATCH, TIMELINE_TILE)

_COMM_KEYS = ("coll", "bytes")


def _stage_pids(events: list) -> dict:
    """pid -> stage index for tracks the metadata names ``stage N``."""
    out = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = (ev.get("args") or {}).get("name", "")
            if isinstance(name, str) and name.startswith("stage "):
                try:
                    out[ev["pid"]] = int(name.split()[1])
                except (ValueError, IndexError):
                    pass
    return out


def _resilience_pid(events: list):
    for ev in events:
        if (ev.get("ph") == "M" and ev.get("name") == "process_name"
                and (ev.get("args") or {}).get("name") == "resilience"):
            return ev["pid"]
    return None


def check_timeline(obj, name: str = "timeline") -> Report:
    """Audit one timeline; accepts the parsed Chrome-trace dict or a
    live :class:`repro_torch.obs.Timeline` (converted via ``chrome_trace()``).
    Returns a :class:`Report` whose ``ok`` is False on any violation."""
    if hasattr(obj, "chrome_trace"):
        obj = obj.chrome_trace()
    rep = Report(name=name)
    from ..obs.timeline import validate_chrome_trace
    problems = validate_chrome_trace(obj)
    for p in problems:
        rep.add(TIMELINE_SCHEMA, p)
    rep.tally("timeline_schema", 1)
    if problems:
        # malformed events make the structural audits unreliable
        return rep
    events = obj.get("traceEvents", [])
    other = obj.get("otherData", {}) or {}
    xs = [e for e in events if e.get("ph") == "X"]

    # ---- comm annotations ----------------------------------------------
    ncomm = 0
    for ev in xs:
        if ev.get("cat") != "comm":
            continue
        ncomm += 1
        args = ev.get("args") or {}
        missing = [k for k in _COMM_KEYS if k not in args]
        if missing:
            rep.add(TIMELINE_COMM_ATTRS,
                    f"comm span {ev.get('name')!r} missing "
                    f"{'/'.join(missing)}",
                    node=ev.get("name"), stage=ev.get("pid"))
    rep.tally("timeline_comm", ncomm)

    # ---- scheduling-stream tiling (simulated timelines only) -----------
    if other.get("kind") == "simulated-execution":
        step_us = float(other.get("step_time_s", 0.0)) * 1e6
        tol = max(1e-6, abs(step_us) * 1e-9)
        stages = _stage_pids(events)
        for pid, s in sorted(stages.items()):
            track = sorted((e for e in xs
                            if e["pid"] == pid and e["tid"] == 0),
                           key=lambda e: (e["ts"], e["ts"] + e["dur"]))
            if not track:
                rep.add(TIMELINE_TILE, "no scheduling spans", stage=s)
                continue
            if abs(track[0]["ts"]) > tol:
                rep.add(TIMELINE_TILE,
                        f"first span starts at {track[0]['ts']:.6g}us, "
                        f"not 0", stage=s)
            for prev, nxt in zip(track, track[1:]):
                prev_end = prev["ts"] + prev["dur"]
                if abs(nxt["ts"] - prev_end) > tol:
                    rep.add(TIMELINE_TILE,
                            f"gap/overlap of "
                            f"{nxt['ts'] - prev_end:.6g}us between "
                            f"{prev.get('name')!r} and {nxt.get('name')!r}",
                            stage=s)
                    break
            last_end = track[-1]["ts"] + track[-1]["dur"]
            if abs(last_end - step_us) > tol:
                rep.add(TIMELINE_STEP_MISMATCH,
                        f"track ends at {last_end:.6g}us, recorded step "
                        f"is {step_us:.6g}us", stage=s)
        rep.tally("timeline_tracks", len(stages))

    # ---- resilience track ----------------------------------------------
    rp = _resilience_pid(events)
    if rp is not None:
        marks = [e for e in xs if e["pid"] == rp
                 and (e.get("args") or {}).get("kind") == "failure"]
        marks.sort(key=lambda e: e["ts"])
        for i, ev in enumerate(marks):
            args = ev.get("args") or {}
            if args.get("epoch") != i:
                rep.add(TIMELINE_RESILIENCE_TRACK,
                        f"failure at {ev['ts']:.6g}us carries epoch "
                        f"{args.get('epoch')}, expected {i} in time order",
                        node=ev.get("name"))
            if ev.get("dur", 0) < 0 or not math.isfinite(ev.get("dur", 0)):
                rep.add(TIMELINE_RESILIENCE_TRACK,
                        f"failure epoch {i} has invalid duration "
                        f"{ev.get('dur')!r}", node=ev.get("name"))
        rep.tally("timeline_resilience", len(marks))
    return rep


def check_timeline_file(path: str) -> Report:
    """:func:`check_timeline` over a saved Chrome-trace JSON file."""
    with open(path) as f:
        obj = json.load(f)
    return check_timeline(obj, name=os.path.basename(path))
