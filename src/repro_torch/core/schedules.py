"""Pipeline-schedule IR + generators (paper §IV-D3, scenario diversity).

A :class:`Schedule` is a per-physical-stage ordered list of
:class:`Slot`\\ s — ``fwd(mb, vstage)`` / ``bwd(mb, vstage)`` (or the
zero-bubble split ``bwd_in``/``bwd_w``) — plus the derived in-flight
activation count each stage must hold.  Generators cover the four
schedules that dominate the bubble/memory trade-off at scale:

* ``gpipe``        — all forwards, then all backwards (max activations).
* ``1f1b``         — Megatron/PipeDream 1F1B: warm-up of ``pp-1-s``
  forwards, then strict fwd/bwd alternation (in-flight ``min(M, pp-s)``).
* ``interleaved``  — Megatron interleaved 1F1B with ``vstages`` virtual
  chunks per stage (bubble shrinks ~``1/vstages``; needs ``M % pp == 0``).
* ``zb-h1``        — zero-bubble H1: backward split into activation-grad
  (``bwd_in``, on the critical path) and weight-grad (``bwd_w``, delayed
  to fill the cool-down bubble); same activation memory as 1F1B.

The timing replay (:func:`replay`) is *pure numeric post-processing*
over per-(virtual-)stage phase durations: both evaluation backends
produce the same :class:`~repro_torch.core.instantiate.Workload` and feed the
same replay, so compiled-vs-sympy parity is preserved by construction
(tests/test_backend_parity.py).  Slot durations are microbatch-
independent (SPMD), so a schedule's timing needs only
``(kind, vstage) -> seconds``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

from .matcher import InfeasibleConfigError

SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb-h1")

# slot kinds; "bwd_in"/"bwd_w" only appear in backward-splitting schedules
FWD, BWD, BWD_IN, BWD_W = "fwd", "bwd", "bwd_in", "bwd_w"


class Slot(NamedTuple):
    """One unit of pipeline work: a phase of one microbatch on one
    virtual stage (``vstage`` is the *global* chunk id in
    ``[0, pp * vstages)``; chunk ``c`` executes on physical stage
    ``c % pp``)."""
    kind: str
    mb: int
    vstage: int


@dataclass(frozen=True)
class Schedule:
    """Per-stage slot timelines for one (schedule, pp, M, vstages)."""
    name: str
    pp: int
    microbatches: int
    vstages: int
    timelines: tuple           # tuple[stage] of tuple[Slot, ...]

    @property
    def chunks(self) -> int:
        return self.pp * self.vstages

    @property
    def splits_backward(self) -> bool:
        return any(s.kind == BWD_W for s in self.timelines[-1])

    def stage_chunks(self, stage: int) -> tuple:
        """Global chunk ids hosted by ``stage`` (interleaved: v chunks)."""
        return tuple(range(stage, self.chunks, self.pp))

    def inflight(self, stage: int):
        """Max concurrently-alive activation sets on ``stage``, in units
        of ONE microbatch through ALL of the stage's chunks (what the
        memory model's ``peak_activation`` measures).  A forward slot
        admits 1/vstages of such a set; it is released by the matching
        ``bwd`` (or ``bwd_in`` — zero-bubble frees activations once the
        activation grad is done, which is why ZB-H1 matches 1F1B
        memory)."""
        units = peak = 0
        for s in self.timelines[stage]:
            if s.kind == FWD:
                units += 1
                if units > peak:
                    peak = units
            elif s.kind in (BWD, BWD_IN):
                units -= 1
        if self.vstages == 1:
            return max(1, peak)
        return max(1.0, peak / self.vstages)


# --------------------------------------------------------------------------
# Generators
# --------------------------------------------------------------------------

def _gpipe(pp: int, mb: int) -> list:
    tls = []
    for s in range(pp):
        tl = [Slot(FWD, k, s) for k in range(mb)]
        tl += [Slot(BWD, k, s) for k in reversed(range(mb))]
        tls.append(tuple(tl))
    return tls


def _1f1b(pp: int, mb: int) -> list:
    tls = []
    for s in range(pp):
        w = min(mb, pp - 1 - s)
        tl = [Slot(FWD, k, s) for k in range(w)]
        for j in range(mb - w):
            tl.append(Slot(FWD, w + j, s))
            tl.append(Slot(BWD, j, s))
        for j in range(mb - w, mb):
            tl.append(Slot(BWD, j, s))
        tls.append(tuple(tl))
    return tls


def _zb_h1(pp: int, mb: int) -> list:
    """ZB-H1 (Qi et al., PAPERS.md): 1F1B with the weight-grad halves
    lagged ``w`` microbatches so they fill the cool-down bubble."""
    tls = []
    for s in range(pp):
        w = min(mb, pp - 1 - s)
        tl = [Slot(FWD, k, s) for k in range(w)]
        next_w = 0
        for j in range(mb):
            if j < mb - w:
                tl.append(Slot(FWD, w + j, s))
            tl.append(Slot(BWD_IN, j, s))
            if j >= w:
                tl.append(Slot(BWD_W, next_w, s))
                next_w += 1
        while next_w < mb:
            tl.append(Slot(BWD_W, next_w, s))
            next_w += 1
        tls.append(tuple(tl))
    return tls


def _interleaved(pp: int, mb: int, v: int) -> list:
    """Megatron-LM interleaved 1F1B: units are (microbatch, chunk) pairs
    walked in groups of ``pp`` microbatches across chunks; warm-up depth
    ``2(pp-1-s) + (v-1)*pp`` units."""
    if mb % pp != 0:
        raise InfeasibleConfigError(
            f"interleaved schedule needs microbatches ({mb}) divisible by "
            f"pp ({pp})")
    total = mb * v
    group = pp * v

    def f_unit(i: int, s: int) -> Slot:
        g, pos = divmod(i, group)
        return Slot(FWD, g * pp + pos % pp, (pos // pp) * pp + s)

    def b_unit(i: int, s: int) -> Slot:
        g, pos = divmod(i, group)
        return Slot(BWD, g * pp + pos % pp, (v - 1 - pos // pp) * pp + s)

    tls = []
    for s in range(pp):
        if mb == pp:
            w = total
        else:
            w = min(total, 2 * (pp - 1 - s) + (v - 1) * pp)
        tl = [f_unit(i, s) for i in range(w)]
        for j in range(total - w):
            tl.append(f_unit(w + j, s))
            tl.append(b_unit(j, s))
        for j in range(total - w, total):
            tl.append(b_unit(j, s))
        tls.append(tuple(tl))
    return tls


@functools.lru_cache(maxsize=512)
def build_schedule(name: str, pp: int, microbatches: int,
                   vstages: int = 1) -> Schedule:
    """Generate the slot timelines for one schedule point (cached —
    sweeps replay the same (pp, M) grid thousands of times)."""
    if name not in SCHEDULES:
        raise ValueError(f"schedule {name!r} not in {SCHEDULES}")
    pp = max(1, pp)
    mb = max(1, microbatches)
    v = max(1, vstages) if name == "interleaved" and pp > 1 else 1
    if name == "gpipe":
        tls = _gpipe(pp, mb)
    elif name == "1f1b":
        tls = _1f1b(pp, mb)
    elif name == "zb-h1":
        tls = _zb_h1(pp, mb)
    else:
        tls = _interleaved(pp, mb, v) if pp > 1 else _1f1b(pp, mb)
    return Schedule(name=name, pp=pp, microbatches=mb, vstages=v,
                    timelines=tuple(tls))


@functools.lru_cache(maxsize=4096)
def inflight_factor(name: str, pp: int, microbatches: int, vstages: int,
                    stage: int):
    """Pipeline in-flight activation multiplier for the memory model.

    Both evaluation backends call exactly this function, so the factor
    is bit-identical by construction.  For ``1f1b`` it reproduces the
    classic ``min(M, pp - stage)``."""
    if pp <= 1:
        return 1
    return build_schedule(name, pp, microbatches, vstages).inflight(stage)


# --------------------------------------------------------------------------
# Numeric timing replay
# --------------------------------------------------------------------------

@dataclass
class ReplayResult:
    makespan: float            # all microbatch work done (excl. optimizer)
    finish: list               # per physical stage
    busy: list                 # per physical stage: sum of slot durations

    @property
    def bubble_fraction(self) -> float:
        if self.makespan <= 0.0 or not self.finish:
            return 0.0
        total = self.makespan * len(self.finish)
        return max(0.0, 1.0 - sum(self.busy) / total)


def _dep_key(slot: Slot, chunks: int):
    """Cross-slot dependency: fwd chains down the virtual pipeline, the
    backward ("bgrad") chain climbs back up, weight grads wait on their
    own activation grad."""
    if slot.kind == FWD:
        return ("f", slot.mb, slot.vstage - 1) if slot.vstage > 0 else None
    if slot.kind in (BWD, BWD_IN):
        if slot.vstage < chunks - 1:
            return ("b", slot.mb, slot.vstage + 1)
        return ("f", slot.mb, slot.vstage)       # loss turnaround
    return ("b", slot.mb, slot.vstage)           # bwd_w after own bwd_in


def replay(sched: Schedule, duration: Callable[[Slot], float],
           record: list | None = None) -> ReplayResult:
    """Event-driven replay of the schedule timelines.

    Each stage issues its fwd/bwd slots strictly in order (one execution
    resource per stage — the intra-slot compute/comm overlap already
    happened inside the slot's duration via the two-stream scheduler); a
    slot additionally waits for its cross-stage producer.  ``bwd_w``
    slots are the exception — this is the whole point of zero-bubble
    schedules: a weight grad has no downstream consumer before the
    optimizer, so it *backfills* gaps where the stage would otherwise
    idle waiting for a cross-stage dependency, and any leftovers drain
    after the stage's last in-order slot.  Durations are microbatch-
    independent, so ``duration`` is consulted once per (kind, vstage)
    and memoized here.

    ``record``, when given, receives ``(stage, slot, start, end)`` for
    every executed slot — including backfilled ``bwd_w`` work at its
    actual execution window — from the *same* float arithmetic that
    produces the makespan, so timelines built from it reconcile with
    :class:`~repro_torch.core.simulate.SimResult` exactly (repro_torch.obs)."""
    pp = sched.pp
    chunks = sched.chunks
    dur_cache: dict = {}
    finish: dict = {}
    ptr = [0] * pp
    free = [0.0] * pp
    busy = [0.0] * pp
    pending: list[list] = [[] for _ in range(pp)]     # backfillable bwd_w work

    def dur(slot: Slot) -> float:
        d = dur_cache.get((slot.kind, slot.vstage))
        if d is None:
            d = duration(slot)
            dur_cache[(slot.kind, slot.vstage)] = d
        return d

    remaining = sum(len(t) for t in sched.timelines)
    while remaining:
        progressed = False
        for s in range(pp):
            tl = sched.timelines[s]
            while ptr[s] < len(tl):
                slot = tl[ptr[s]]
                if slot.kind == BWD_W:
                    # static position guarantees its bwd_in already ran;
                    # execution is deferred to the next idle gap
                    pending[s].append((slot, dur(slot)))
                    ptr[s] += 1
                    remaining -= 1
                    progressed = True
                    continue
                dep = _dep_key(slot, chunks)
                if dep is not None and dep not in finish:
                    break
                ready = finish[dep] if dep is not None else 0.0
                # backfill weight grads that fit entirely in the idle gap
                while pending[s] and free[s] + pending[s][0][1] <= ready:
                    wslot, d = pending[s].pop(0)
                    if record is not None:
                        record.append((s, wslot, free[s], free[s] + d))
                    free[s] += d
                    busy[s] += d
                d = dur(slot)
                start = free[s] if free[s] > ready else ready
                end = start + d
                if slot.kind == FWD:
                    finish[("f", slot.mb, slot.vstage)] = end
                else:
                    finish[("b", slot.mb, slot.vstage)] = end
                if record is not None:
                    record.append((s, slot, start, end))
                free[s] = end
                busy[s] += d
                ptr[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError(
                f"pipeline schedule {sched.name!r} deadlocked at "
                f"{[sched.timelines[s][ptr[s]] if ptr[s] < len(sched.timelines[s]) else None for s in range(pp)]}")
    for s in range(pp):                               # drain leftover bwd_w
        for wslot, d in pending[s]:
            if record is not None:
                record.append((s, wslot, free[s], free[s] + d))
            free[s] += d
            busy[s] += d
    return ReplayResult(makespan=max(free), finish=free, busy=busy)
