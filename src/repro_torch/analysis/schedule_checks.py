"""Schedule checks over the slot-timeline IR in ``repro_torch.core.schedules``.

Static validation of a :class:`~repro_torch.core.schedules.Schedule`: slot
coverage (every microbatch runs every phase on every chunk exactly
once), intra-timeline ordering (bwd after fwd, ``bwd_w`` after its
``bwd_in``), and deadlock-freedom of the cross-stage event graph — the
same dependency keys the timing replay uses, walked without durations.
"""
from __future__ import annotations

from typing import Optional

from ..core.instantiate import Workload
from ..core.schedules import (BWD, BWD_IN, BWD_W, FWD, Schedule, Slot,
                              _dep_key, build_schedule)
from .diagnostics import (BWD_SPLIT_ORDER, PHASE_NEVER_RAN, Report,
                          SCHEDULE_DEADLOCK, SLOT_COVERAGE)


def check_schedule(sched: Schedule, *, name: str = "") -> Report:
    """Run the ``STG2xx`` rules over one schedule."""
    rep = Report(name=name or f"schedule/{sched.name}")
    _check_coverage(sched, rep)
    _check_ordering(sched, rep)
    _check_deadlock(sched, rep)
    rep.tally("schedule_checks", sum(len(t) for t in sched.timelines))
    return rep


def check_workload_schedule(w: Workload, *, name: str = "") -> Report:
    """Validate the workload's configured schedule AND that the workload
    actually hosts a phase body for every (stage, chunk) slot the
    schedule references — a slot whose phase has no nodes would replay
    a microbatch phase that never ran."""
    cfg = w.cfg
    sched = build_schedule(getattr(cfg, "schedule", "1f1b"), max(1, cfg.pp),
                           cfg.microbatches, getattr(cfg, "vstages", 1))
    rep = check_schedule(sched, name=name or w.name)
    if cfg.pp > 1:
        stages = w.stages
        if stages != sched.pp:
            rep.add(PHASE_NEVER_RAN,
                    f"schedule spans {sched.pp} stages but the workload "
                    f"instantiated {stages}",
                    fixit="re-cut the pipeline with matching pp")
            return rep
        for s in range(sched.pp):
            hosted = set(w.vstages_of(s))
            for slot in sched.timelines[s]:
                if slot.vstage not in hosted:
                    rep.add(PHASE_NEVER_RAN,
                            f"stage {s} schedules {slot.kind} of chunk "
                            f"{slot.vstage} but hosts only chunks "
                            f"{sorted(hosted)}",
                            stage=s, phase=slot.kind,
                            fixit="align ParallelCfg.vstages with the "
                                  "pipeline plan's chunking")
                    break           # one diagnostic per stage suffices
    return rep


# --------------------------------------------------------------------------

def _check_coverage(sched: Schedule, rep: Report) -> None:
    split = sched.splits_backward
    mb = sched.microbatches
    for s, tl in enumerate(sched.timelines):
        counts: dict[tuple[str, int, int], int] = {}
        for slot in tl:
            key = (slot.kind, slot.mb, slot.vstage)
            counts[key] = counts.get(key, 0) + 1
        hosted = sched.stage_chunks(s)
        want_kinds = (FWD, BWD_IN, BWD_W) if split else (FWD, BWD)
        for c in hosted:
            for kind in want_kinds:
                for k in range(mb):
                    n = counts.pop((kind, k, c), 0)
                    if n != 1:
                        rep.add(SLOT_COVERAGE,
                                f"stage {s}: {kind}(mb={k}, chunk={c}) "
                                f"appears {n} times (expected once)",
                                stage=s, phase=kind,
                                fixit="regenerate the timeline with "
                                      "build_schedule instead of editing "
                                      "slots")
        for (kind, k, c), n in counts.items():
            rep.add(SLOT_COVERAGE,
                    f"stage {s}: unexpected slot {kind}(mb={k}, "
                    f"chunk={c}) ×{n} — chunk not hosted by this stage "
                    f"or phase kind foreign to schedule "
                    f"{sched.name!r}",
                    stage=s, phase=kind)


def _check_ordering(sched: Schedule, rep: Report) -> None:
    for s, tl in enumerate(sched.timelines):
        done: set[tuple[str, int, int]] = set()
        for slot in tl:
            if slot.kind in (BWD, BWD_IN):
                if (FWD, slot.mb, slot.vstage) not in done:
                    rep.add(PHASE_NEVER_RAN,
                            f"stage {s}: {slot.kind}(mb={slot.mb}, "
                            f"chunk={slot.vstage}) consumes activations "
                            f"of a forward that has not run on this "
                            f"stage",
                            stage=s, phase=slot.kind)
            elif slot.kind == BWD_W:
                if (BWD_IN, slot.mb, slot.vstage) not in done:
                    rep.add(BWD_SPLIT_ORDER,
                            f"stage {s}: bwd_w(mb={slot.mb}, "
                            f"chunk={slot.vstage}) precedes its bwd_in — "
                            f"the weight grad would read an activation "
                            f"grad that does not exist yet",
                            stage=s, phase=BWD_W,
                            fixit="zb-h1 timelines must order bwd_in "
                                  "before the matching bwd_w")
            done.add((slot.kind, slot.mb, slot.vstage))


def _check_deadlock(sched: Schedule, rep: Report) -> None:
    """Durationless replay of the cross-stage event graph (the exact
    dependency keys :func:`repro_torch.core.schedules.replay` blocks on)."""
    pp = sched.pp
    chunks = sched.chunks
    ptr = [0] * pp
    finish: set = set()
    remaining = sum(len(t) for t in sched.timelines)
    while remaining:
        progressed = False
        for s in range(pp):
            tl = sched.timelines[s]
            while ptr[s] < len(tl):
                slot = tl[ptr[s]]
                if slot.kind != BWD_W:          # bwd_w is backfillable
                    dep = _dep_key(slot, chunks)
                    if dep is not None and dep not in finish:
                        break
                    tag = "f" if slot.kind == FWD else "b"
                    finish.add((tag, slot.mb, slot.vstage))
                ptr[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            blocked = [(s, sched.timelines[s][ptr[s]])
                       for s in range(pp)
                       if ptr[s] < len(sched.timelines[s])]
            head = ", ".join(f"stage{s}@{sl.kind}(mb={sl.mb}, "
                             f"chunk={sl.vstage})" for s, sl in blocked[:4])
            rep.add(SCHEDULE_DEADLOCK,
                    f"replay of schedule {sched.name!r} (pp={pp}, "
                    f"mb={sched.microbatches}) stalls with "
                    f"{len(blocked)} stage(s) blocked: {head}",
                    phase=sched.name,
                    fixit="every slot's cross-stage producer must appear "
                          "earlier in some timeline; regenerate with "
                          "build_schedule")
            return


def slot_exists(sched: Schedule, slot: Slot, stage: Optional[int] = None
                ) -> bool:
    """Convenience for tests: does ``slot`` appear on ``stage`` (or
    anywhere)?"""
    tls = sched.timelines if stage is None else (sched.timelines[stage],)
    return any(slot == s for tl in tls for s in tl)
