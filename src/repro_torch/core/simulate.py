"""Event-driven replay of the instantiated workload (compute/comm overlap).

A light-weight stand-in for the paper's ASTRA-sim backend: each rank has
a *compute stream* and a *comm stream*; nodes become ready when their
data deps finish and execute on their stream's earliest free slot, so
independent collectives hide behind compute (the FSDP observation of
paper Fig 10 falls out of this naturally — weight AllGathers depend only
on root weights and prefetch arbitrarily early).

Pipeline parallelism replays the configured schedule
(:mod:`repro_torch.core.schedules`): per (virtual) stage the two-stream
scheduler times the forward / backward (/ split weight-grad) slot
bodies — cross-stage SendRecv landing costs included in the receiving
chunk's slot — and the numeric schedule replay chains the slots through
their cross-stage dependencies.  Because the replay consumes only
per-slot durations, both evaluation backends (sympy reference and
compiled) share it unchanged and stay bit-identical.

Time-accounting semantics (pinned by tests/test_schedules.py):

* ``step_time``    — schedule makespan (pp=1: ``M · t_mb``) + optimizer.
* ``compute_time`` — max over stages of per-step compute-stream busy
  time: microbatch compute × M + optimizer compute (the optimizer runs
  ONCE per step, not per microbatch).
* ``comm_time`` / ``exposed_comm`` — same accounting on the comm stream.
* ``bubble_fraction`` — fraction of stage-time idle during the
  microbatch portion of the schedule (0 when pp == 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .collectives import CollectiveModel, comm_model
from .costmodel import HardwareProfile
from .instantiate import NodeRec, Workload
from .schedules import BWD, BWD_IN, BWD_W, FWD, Slot, build_schedule, replay


@dataclass
class StageSim:
    t_fwd: float                 # per-microbatch forward span (all chunks)
    t_bwd: float                 # per-microbatch backward span (all chunks)
    t_opt: float
    compute_busy: float          # per-microbatch compute-stream busy (no opt)
    comm_busy: float             # per-microbatch comm-stream busy (no opt)
    exposed_comm: float          # per-microbatch comm not hidden by compute
    opt_compute: float = 0.0     # once-per-step optimizer busy times
    opt_comm: float = 0.0
    opt_exposed: float = 0.0

    @property
    def t_microbatch(self) -> float:
        return self.t_fwd + self.t_bwd


@dataclass
class SimResult:
    step_time: float
    compute_time: float          # max-stage per-step compute busy
    comm_time: float             # max-stage per-step comm busy
    exposed_comm: float          # max-stage per-step exposed comm
    overlap_ratio: float         # fraction of comm hidden under compute
    bubble_fraction: float = 0.0  # pipeline idle fraction (microbatch part)
    schedule: str = "1f1b"
    stages: list[StageSim] = field(default_factory=list)

    @property
    def ms(self) -> float:
        return self.step_time * 1e3


@dataclass
class TimelineRecorder:
    """Raw material for :func:`repro_torch.obs.timeline.build_timeline`.

    Passed as ``simulate(..., record=rec)``, it captures — from the
    exact float arithmetic that produces ``SimResult.step_time`` —

    * ``placements``: replayed ``(stage, Slot, start, end)`` windows
      (pp > 1; synthesized ``[k·span, (k+1)·span]`` slots for pp == 1),
    * ``node_events``: per-``(kind, chunk)`` slot-body node schedules
      ``(node, stream, start, end)`` relative to the slot's own zero
      and UNSCALED by straggler multipliers (see ``multipliers``),
    * ``slot_durs`` / ``opt_spans``: the (scaled) spans the replay and
      the step-time formula consumed,

    so a timeline built from it reconciles with the step time *by
    construction* — no parallel re-implementation of the cost model.
    Both evaluation backends share :func:`simulate`, hence one recorder
    serves both."""
    placements: list = field(default_factory=list)   # (stage, Slot, start, end)
    node_events: dict = field(default_factory=dict)  # (kind, chunk) -> [(node, stream, t0, t1)]
    slot_durs: dict = field(default_factory=dict)    # (kind, chunk) -> span (scaled)
    opt_events: dict = field(default_factory=dict)   # stage -> [(node, stream, t0, t1)]
    opt_spans: dict = field(default_factory=dict)    # stage -> span (scaled)
    multipliers: Optional[tuple] = None              # per-stage straggler dilation
    sched_name: str = ""
    pp: int = 1
    vstages: int = 1
    microbatches: int = 0
    stages: int = 1
    makespan: float = 0.0                            # microbatch portion end
    step_time: float = 0.0
    result: Optional[SimResult] = None

    def stage_of(self, chunk: int) -> int:
        return chunk % self.pp


def sum_convex_series(f, lo: int, hi: int, *, rel_tol: float = 1e-9,
                      seed: dict | None = None) -> tuple[float, int]:
    """``sum(f(t) for t in lo..hi)`` in O(1) evaluations for (piecewise-)
    linear ``f``; returns ``(total, evaluations)``.

    The decode-series summation engine: a decode step's simulated time
    is built from ``+`` and ``max`` over affine functions of the KV
    length, so it is CONVEX piecewise-linear in the decode index.  For a
    convex function the midpoint lies on the chord iff the function is
    linear on the interval, so the adaptive split below is *exact* on
    linear stretches (the arithmetic-series closed form) and only
    recurses at genuine breakpoints — ``rel_tol`` pins the equality test
    against float noise.  A 512-step generation whose cost grows
    linearly in KV costs 3 evaluations, not 512.

    ``seed`` pre-populates the evaluation cache (``{t: f(t)}``) with
    values the caller already computed — seeded points are not counted
    in the returned evaluation count."""
    cache: dict[int, float] = dict(seed or {})
    calls = 0

    def g(t: int) -> float:
        nonlocal calls
        v = cache.get(t)
        if v is None:
            v = f(t)
            calls += 1
            cache[t] = v
        return v

    def rec(a: int, b: int, fa: float, fb: float) -> float:
        n = b - a + 1
        if n <= 4:
            return sum(g(t) for t in range(a, b + 1))
        m = (a + b) // 2
        fm = g(m)
        chord = fa + (fb - fa) * (m - a) / (b - a)
        scale = max(abs(fa), abs(fb), abs(fm))
        if abs(fm - chord) <= rel_tol * scale:
            # linear on [a, b]: exact integer-point arithmetic series
            slope = (fb - fa) / (b - a)
            return n * fa + slope * n * (n - 1) / 2.0
        return rec(a, m, fa, fm) + rec(m + 1, b, g(m + 1), fb)

    if hi < lo:
        return 0.0, 0
    total = rec(lo, hi, g(lo), g(hi))
    return total, calls


def _schedule(nodes: list[NodeRec], hw: HardwareProfile,
              model: Optional[CollectiveModel] = None,
              events: list | None = None
              ) -> tuple[float, float, float]:
    """List-schedule on {compute, comm} streams; returns
    (makespan, compute_busy, comm_busy).

    Hot loop: runs once per stage per sweep point, so the stream state
    lives in locals and the roofline model is inlined; collectives go
    through the shared :class:`~repro_torch.core.collectives.CollectiveModel`
    (one lowered record per ``(coll, axis, group)``, so the per-node
    cost is a dict hit + multiply-add).  The costs MUST stay equivalent
    to :func:`repro_torch.core.costmodel.node_time` under the same model —
    tests/test_dse_sweep.py::test_schedule_matches_costmodel pins the
    two together.  NB: ``node_time``'s model-less default cannot see the
    config's placement (it assumes innermost-contiguous groups), so on a
    topology profile with a non-default placement pass
    ``comm_model(hw, cfg)`` explicitly to match what ``simulate``
    charges; on flat profiles the default is exactly equivalent.

    ``events``, when a list, receives ``(node, stream, start, end)`` for
    every scheduled node (stream ``"comp"``/``"comm"``, times relative
    to the slot body's own zero) — the node-level raw material for
    repro_torch.obs timelines."""
    if model is None:
        model = comm_model(hw)
    time_of = model.time_of
    finish: dict[int, float] = {}
    fget = finish.get
    free_comp = free_comm = busy_comp = busy_comm = 0.0
    peak = hw.peak_flops
    hbm = hw.hbm_bw
    eff = hw.efficiency
    for n in nodes:                                  # already topologically ordered
        comm = n.comm
        ready = 0.0
        for d in n.deps:
            t = fget(d, 0.0)
            if t > ready:
                ready = t
        if comm is not None:
            dur = time_of(comm)
            start = ready if ready > free_comm else free_comm
            end = start + dur
            free_comm = end
            busy_comm += dur
            if events is not None:
                events.append((n, "comm", start, end))
        else:
            flops = n.flops
            t_flops = flops / (peak * eff.get(n.category, 0.9)) if flops else 0.0
            t_mem = n.bytes_accessed / hbm
            dur = t_flops if t_flops > t_mem else t_mem
            start = ready if ready > free_comp else free_comp
            end = start + dur
            free_comp = end
            busy_comp += dur
            if events is not None:
                events.append((n, "comp", start, end))
        finish[n.uid] = end
    makespan = free_comp if free_comp > free_comm else free_comm
    return makespan, busy_comp, busy_comm


def _span3(nodes: list[NodeRec], hw: HardwareProfile,
           model: CollectiveModel, events: list | None = None
           ) -> tuple[float, float, float, float]:
    """(span, compute busy, comm busy, exposed comm) for one slot body."""
    span, cbusy, mbusy = _schedule(nodes, hw, model, events)
    return span, cbusy, mbusy, max(0.0, span - cbusy)


def _stage_multipliers(perturb, cfg) -> Optional[tuple[float, ...]]:
    """Normalize a ``perturb`` argument to per-physical-stage busy
    multipliers: objects expose ``stage_multipliers(cfg)`` (the
    :class:`repro_torch.ft.StragglerModel` protocol), plain sequences are
    taken as-is.  ``None`` -> ``None`` (the failure-free fast path)."""
    if perturb is None:
        return None
    if hasattr(perturb, "stage_multipliers"):
        mults = tuple(float(m) for m in perturb.stage_multipliers(cfg))
    else:
        mults = tuple(float(m) for m in perturb)
    pp = max(1, cfg.pp)
    if len(mults) != pp:
        raise ValueError(
            f"perturb yields {len(mults)} stage multipliers for pp={pp}")
    if any(m <= 0 for m in mults):
        raise ValueError(f"stage multipliers must be > 0, got {mults}")
    return mults


def simulate(w: Workload, hw: HardwareProfile, *,
             microbatches: int | None = None,
             recompute: bool = False,
             schedule: str | None = None,
             vstages: int | None = None,
             algorithms: dict | None = None,
             model: CollectiveModel | None = None,
             perturb=None,
             record: TimelineRecorder | None = None) -> SimResult:
    """Analytic step time under ``w.cfg``'s pipeline schedule.

    ``schedule``/``vstages``/``microbatches`` override the config's
    values (what-if analysis without re-instantiating the workload).
    Overrides must match the chunk assignment baked into the workload by
    the pipeline cut: an interleaved-cut workload (``cfg.vstages > 1``)
    can only replay interleaved at the same ``vstages``.

    Collectives are costed by the shared
    :class:`~repro_torch.core.collectives.CollectiveModel` built from ``hw``
    (+ ``w.cfg``'s axis placement when the profile has a topology);
    ``algorithms`` forces per-collective algorithm choices
    (``{"AllReduce": "tree"}``) and ``model`` supplies a pre-built model
    outright.

    ``perturb`` injects stragglers: a :class:`repro_torch.ft.StragglerModel`
    (or a raw per-stage multiplier sequence) scales every slot a stage
    executes — the barrier semantics of synchronous training, where the
    slowest rank in a stage paces the whole stage.  Scaling happens on
    the per-slot durations BEFORE the schedule replay, so both
    evaluation backends (which share this function) stay bit-identical
    under perturbation by construction; ``perturb=None`` leaves every
    code path untouched.

    ``record`` (a :class:`TimelineRecorder`) captures slot placements
    and node-level stream events for repro_torch.obs timeline export; it adds
    only ``record is not None`` checks to the hot paths."""
    cfg = w.cfg
    if model is None:
        model = comm_model(hw, cfg, algorithms)
    mb = microbatches if microbatches is not None else cfg.microbatches
    pp = max(1, cfg.pp)
    sched_name = schedule or getattr(cfg, "schedule", "1f1b")
    wl_v = getattr(cfg, "vstages", 1)
    v = vstages if vstages is not None else wl_v
    mults = _stage_multipliers(perturb, cfg)

    if pp <= 1:
        return _simulate_single(w, hw, mb, recompute, sched_name, model,
                                mult=mults[0] if mults else 1.0,
                                record=record)
    if v != wl_v or (sched_name != "interleaved" and wl_v > 1):
        raise ValueError(
            f"schedule override {sched_name!r}/vstages={v} does not match "
            f"the workload's pipeline cut (vstages={wl_v}); build a new "
            f"trace with .schedule(...) instead")

    sched = build_schedule(sched_name, pp, mb, v)
    split_bwd = sched.splits_backward

    stage_sims: list[StageSim] = []
    dur: dict[tuple[str, int], float] = {}      # (slot kind, chunk) -> span
    for s in range(w.stages):
        nodes = w.stage_nodes(s)
        fwd_c: dict[int, list[NodeRec]] = {}
        bwd_c: dict[int, list[NodeRec]] = {}
        opt_nodes: list[NodeRec] = []
        for n in nodes:
            if n.phase == "fwd":
                fwd_c.setdefault(n.vstage, []).append(n)
            elif n.phase == "bwd":
                bwd_c.setdefault(n.vstage, []).append(n)
            else:
                opt_nodes.append(n)
        m = mults[s] if mults else 1.0

        def span3(nodes, key=None):
            ev = None
            if record is not None and key is not None:
                ev = record.node_events.setdefault(key, [])
            sp, cb, mz, ex = _span3(nodes, hw, model, ev)
            if m != 1.0:        # straggler-paced stage: every slot dilates
                return sp * m, cb * m, mz * m, ex * m
            return sp, cb, mz, ex

        t_fwd = t_bwd = cbusy = mbusy = exposed = 0.0
        for c in sorted(set(fwd_c) | set(bwd_c)):
            fwd = fwd_c.get(c, [])
            bwd = bwd_c.get(c, [])
            f_span, f_cb, f_mb, f_exp = span3(fwd, (FWD, c))
            dur[(FWD, c)] = f_span
            if recompute:
                # activation recompute re-runs the forward during backward
                bwd = bwd + [n for n in fwd if n.comm is None]
            if split_bwd:
                b_in = [n for n in bwd if not n.wgrad]
                b_w = [n for n in bwd if n.wgrad]
                bi_span, bi_cb, bi_mb, bi_exp = span3(b_in, (BWD_IN, c))
                bw_span, bw_cb, bw_mb, bw_exp = span3(b_w, (BWD_W, c))
                dur[(BWD_IN, c)] = bi_span
                dur[(BWD_W, c)] = bw_span
                b_span = bi_span + bw_span
                b_cb, b_mb, b_exp = bi_cb + bw_cb, bi_mb + bw_mb, bi_exp + bw_exp
            else:
                b_span, b_cb, b_mb, b_exp = span3(bwd, (BWD, c))
                dur[(BWD, c)] = b_span
            t_fwd += f_span
            t_bwd += b_span
            cbusy += f_cb + b_cb
            mbusy += f_mb + b_mb
            exposed += f_exp + b_exp
        opt_events = None
        if record is not None:
            opt_events = record.opt_events.setdefault(s, [])
        opt_span, ocbusy, ombusy = _schedule(opt_nodes, hw, model, opt_events)
        if m != 1.0:
            opt_span, ocbusy, ombusy = opt_span * m, ocbusy * m, ombusy * m
        stage_sims.append(StageSim(
            t_fwd=t_fwd, t_bwd=t_bwd, t_opt=opt_span,
            compute_busy=cbusy, comm_busy=mbusy, exposed_comm=exposed,
            opt_compute=ocbusy, opt_comm=ombusy,
            opt_exposed=max(0.0, opt_span - ocbusy)))

    rep = replay(sched, lambda slot: dur.get((slot.kind, slot.vstage), 0.0),
                 record.placements if record is not None else None)
    t_opt = max(s.t_opt for s in stage_sims)
    step = rep.makespan + t_opt
    res = _result(step, mb, stage_sims, rep.bubble_fraction, sched_name)
    if record is not None:
        record.slot_durs = dict(dur)
        record.opt_spans = {i: st.t_opt for i, st in enumerate(stage_sims)}
        record.multipliers = mults
        record.sched_name = sched_name
        record.pp, record.vstages, record.microbatches = pp, v, mb
        record.stages = w.stages
        record.makespan = rep.makespan
        record.step_time = step
        record.result = res
    return res


def _simulate_single(w: Workload, hw: HardwareProfile, mb: int,
                     recompute: bool, sched_name: str,
                     model: CollectiveModel, mult: float = 1.0,
                     record: "TimelineRecorder | None" = None) -> SimResult:
    """pp == 1: no pipeline — one combined fwd+bwd span per microbatch
    (kept on the exact pre-schedule-refactor arithmetic: the bulk of any
    DSE sweep is pp == 1 points and this is their hot path)."""
    nodes = w.stage_nodes(0)
    mb_nodes = [n for n in nodes if n.phase in ("fwd", "bwd")]
    if recompute:
        extra = [n for n in nodes if n.phase == "fwd" and n.comm is None]
        mb_nodes = mb_nodes + extra
    opt_nodes = [n for n in nodes if n.phase == "opt"]
    mb_events = opt_events = None
    if record is not None:
        mb_events = record.node_events.setdefault((FWD, 0), [])
        opt_events = record.opt_events.setdefault(0, [])
    span, cbusy, mbusy = _schedule(mb_nodes, hw, model, mb_events)
    opt_span, ocbusy, ombusy = _schedule(opt_nodes, hw, model, opt_events)
    if mult != 1.0:             # the slowest rank paces the whole step
        span, cbusy, mbusy = span * mult, cbusy * mult, mbusy * mult
        opt_span, ocbusy, ombusy = (opt_span * mult, ocbusy * mult,
                                    ombusy * mult)
    st = StageSim(
        t_fwd=span, t_bwd=0.0, t_opt=opt_span,
        compute_busy=cbusy, comm_busy=mbusy,
        exposed_comm=max(0.0, span - cbusy),
        opt_compute=ocbusy, opt_comm=ombusy,
        opt_exposed=max(0.0, opt_span - ocbusy))
    step = mb * span + opt_span
    res = _result(step, mb, [st], 0.0, sched_name)
    if record is not None:
        # slots tile [0, M·span]: slot k at [k·span, (k+1)·span], so the
        # last end is the SAME float product M·span the step formula uses
        record.placements = [(0, Slot(FWD, k, 0), k * span, (k + 1) * span)
                             for k in range(mb)]
        record.slot_durs = {(FWD, 0): span}
        record.opt_spans = {0: opt_span}
        record.multipliers = (mult,) if mult != 1.0 else None
        record.sched_name = sched_name
        record.pp, record.vstages, record.microbatches = 1, 1, mb
        record.stages = 1
        record.makespan = mb * span
        record.step_time = step
        record.result = res
    return res


def _result(step: float, mb: int, stage_sims: list[StageSim],
            bubble: float, sched_name: str) -> SimResult:
    compute = max(s.compute_busy * mb + s.opt_compute for s in stage_sims)
    comm = max(s.comm_busy * mb + s.opt_comm for s in stage_sims)
    exposed = max(s.exposed_comm * mb + s.opt_exposed for s in stage_sims)
    hidden = max(0.0, comm - exposed)
    return SimResult(
        step_time=step,
        compute_time=compute,
        comm_time=comm,
        exposed_comm=exposed,
        overlap_ratio=(hidden / comm) if comm > 0 else 1.0,
        bubble_fraction=bubble,
        schedule=sched_name,
        stages=stage_sims)
