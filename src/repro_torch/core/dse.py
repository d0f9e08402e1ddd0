"""Design-space exploration driver (paper §VI-A, Fig 8/9).

Enumerates parallelization strategies for a fixed device count, runs the
full STAGE pipeline (assemble → distribute → pipeline-cut → instantiate)
for each point, and scores it with the analytical simulator + memory
model.  This doubles as the runtime framework's auto-parallelism
advisor: rank configurations before compiling anything.

Two evaluation backends:

* ``backend="compiled"`` (default) — a :class:`~repro_torch.core.compiled.CompiledBackend`
  shared across the sweep lowers each distributed-graph *structure
  class* once into a lambdified numeric cost program and replays it per
  config, so most points cost array arithmetic instead of sympy
  substitutions (≥10× on Fig-8-style sweeps).
* ``backend="sympy"`` — the reference path (:func:`evaluate_point`),
  one full symbolic pipeline per config.

Points can be evaluated concurrently (``workers`` > 1): configs are
chunked over a ``concurrent.futures`` thread pool and results are
reassembled in enumeration order, so the returned ranking is
deterministic regardless of worker count.

Infeasible factorizations are no longer silently dropped: only
:class:`~repro_torch.core.matcher.InfeasibleConfigError` is caught, and every
skipped config is recorded with its reason on ``SweepResult.skipped``.

The preferred entrypoint is :meth:`repro_torch.api.Scenario.sweep`, which
calls :func:`sweep` with a ``build`` that clones ONE cached symbolic
assembly per mode; the callable-based :func:`sweep` stays public for
callers that need a custom ``build`` (a plain
``lambda: build_graph(spec).graph`` re-assembles per point).

Own copy of ``repro.core.dse``; ``backend="batched"`` runs on ``device``.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from ..obs import metrics as _metrics
from ..obs.log import get_logger
from ..obs.spans import span as _span
from .compiled import _PER_RANK_COLLS, CompiledBackend, collective_wire
from .costmodel import HardwareProfile, TPU_V5E
from .distribute import ParallelCfg, distribute
from .graphdist import apply_pipeline
from .instantiate import Workload, instantiate
from .matcher import InfeasibleConfigError
from .memory import MemoryReport, peak_memory
from .simulate import SimResult, simulate
from .symbolic import Env, sym
from .topology import normalize_placement

_log = get_logger("core.dse")


class _Progress:
    """Thread-safe sweep progress fan-out for ``sweep(progress=...)``.

    Invokes the callback as ``progress(done, total, skipped, eta)`` after
    every completed unit (one config, or one chunk on the process path):
    ``done`` counts configs resolved either way, ``skipped`` the subset
    rejected as infeasible, ``eta`` the remaining-seconds estimate from
    the running rate (``None`` until the first completion).  Callback
    exceptions propagate — a broken progress bar should fail loudly, not
    corrupt the sweep silently."""

    def __init__(self, callback: Optional[Callable], total: int):
        self.callback = callback
        self.total = total
        self.done = 0
        self.skipped = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def tick(self, n: int = 1, skipped: int = 0) -> None:
        if self.callback is None:
            return
        with self._lock:
            self.done += n
            self.skipped += skipped
            done, total, sk = self.done, self.total, self.skipped
            elapsed = time.perf_counter() - self._t0
        eta = (elapsed / done) * (total - done) if done else None
        self.callback(done, total, sk, eta)


@dataclass
class DSEPoint:
    cfg: ParallelCfg
    sim: SimResult
    mem: MemoryReport
    label: str = ""
    resilience: object = None    # ft.ResilienceReport when swept with one

    @property
    def step_ms(self) -> float:
        return self.sim.step_time * 1e3

    @property
    def peak_gb(self) -> float:
        return self.mem.peak_gb

    @property
    def goodput(self) -> float:
        """Useful fraction of wall clock (1.0 without a resilience spec)."""
        return self.resilience.goodput if self.resilience else 1.0

    @property
    def effective_step_time(self) -> float:
        """Step time deflated by goodput — wall seconds per useful step
        once checkpoint writes, lost work, and restores are charged."""
        return self.sim.step_time / self.goodput

    @property
    def effective_step_ms(self) -> float:
        return self.effective_step_time * 1e3

    def row(self) -> dict:
        out = {"strategy": self.cfg.describe(), "step_ms": round(self.step_ms, 3),
               "peak_gb": round(self.peak_gb, 2),
               "overlap": round(self.sim.overlap_ratio, 3),
               "exposed_comm_ms": round(self.sim.exposed_comm * 1e3, 3)}
        if self.resilience is not None:
            out["eff_step_ms"] = round(self.effective_step_ms, 3)
            out.update(self.resilience.row())
        return out


@dataclass
class SkippedConfig:
    """A config the sweep could not realize, with the reason why.

    ``prefiltered`` marks configs rejected by the cheap pre-dispatch
    feasibility check (microbatch divisibility, schedule constraints)
    rather than by the pipeline itself; ``diagnostics`` carries
    structured :class:`repro_torch.analysis.Diagnostic` records when the sweep
    ran with ``verify=True``."""
    cfg: ParallelCfg
    reason: str
    prefiltered: bool = False
    diagnostics: list = field(default_factory=list)


def _prune_bucket(reason: str) -> str:
    """Coarse classification of a skip reason for :attr:`SweepResult.pruned`."""
    low = reason.lower()
    if "microbatch" in low:
        return "microbatch_indivisible"
    if "interleaved" in low or "vstage" in low:
        return "schedule_constraint"
    if "world" in low:
        return "world_mismatch"
    if "divis" in low or "divide" in low:
        return "divisibility"
    return "other"


class SweepResult(list):
    """Feasible :class:`DSEPoint` list (sorted by step time) plus the
    configs that were skipped as infeasible.  Subclasses ``list`` so all
    pre-existing ``sweep(...)[0]`` / iteration call sites keep working.

    ``pruned`` tallies the skipped configs by coarse reason bucket
    (e.g. ``microbatch_indivisible``) so sweep summaries can say *why*
    the feasible set shrank, not just that it did.

    Search/backend accounting (:meth:`summary`): ``engine_stats`` carries
    :meth:`CompiledBackend.stats` (structure classes, compiles, cache
    hits), ``batch_stats`` the batched backend's kernel/batch-size
    record, and for ``search != "full"`` the result holds only the
    Pareto front — ``evaluated``/``visited``/``total`` say what it cost."""

    def __init__(self, points=(), skipped=(), backend: str = "compiled", *,
                 search: str = "full", engine_stats: Optional[dict] = None,
                 batch_stats: Optional[dict] = None,
                 evaluated: Optional[int] = None,
                 visited: Optional[int] = None,
                 total: Optional[int] = None,
                 certificates=None):
        super().__init__(points)
        self.skipped: list[SkippedConfig] = list(skipped)
        self.backend = backend
        self.search = search
        self.engine_stats = engine_stats
        self.batch_stats = batch_stats
        self.evaluated = evaluated
        self.visited = visited
        self.total = total
        # SpaceCertificate from sweep(prove=True): the symbolic-invariant
        # proof over every structure class the sweep replays
        self.certificates = certificates

    @property
    def points(self) -> list[DSEPoint]:
        return list(self)

    @property
    def pruned(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.skipped:
            b = _prune_bucket(s.reason)
            out[b] = out.get(b, 0) + 1
        return out

    def summary(self) -> str:
        bits = [f"{len(self)} feasible point(s)"]
        if self.search == "pareto":
            bits[0] = (f"{len(self)} Pareto-front point(s) of "
                       f"{self.evaluated} evaluated")
        elif self.search == "bnb":
            visited = self.visited or 0
            # total == 0 happens when every enumerated config was
            # prefiltered as infeasible — report the counts without
            # pretending a percentage exists
            pct = (f"{100.0 * visited / self.total:.1f}%" if self.total
                   else "n/a")
            bits[0] = (f"{len(self)} Pareto-front point(s); branch-and-"
                       f"bound visited {visited}/{self.total or 0} "
                       f"configs ({pct})")
        if self.skipped:
            pruned = ", ".join(f"{k}={v}"
                               for k, v in sorted(self.pruned.items()))
            bits.append(f"{len(self.skipped)} skipped ({pruned})")
        es = self.engine_stats
        if es:
            lookups = es.get("compiles", 0) + es.get("hits", 0)
            # no lookups (all configs prefiltered): a 0% ratio would be a
            # lie — nothing was ever asked of the engine
            ratio = (f"{100.0 * es['hits'] / lookups:.0f}% hit ratio"
                     if lookups else "n/a hit ratio")
            bits.append(f"engine: {es.get('classes', 0)} structure "
                        f"class(es), {es.get('compiles', 0)} compile(s), "
                        f"{es.get('hits', 0)} hit(s) ({ratio})")
        if self.certificates is not None:
            bits.append(f"proved: {self.certificates.summary()}")
        bs = self.batch_stats
        if bs and bs.get("batch_sizes"):
            sizes = bs["batch_sizes"]
            mean = sum(sizes) / len(sizes)
            bits.append(f"batched: {bs['points']} point(s) in "
                        f"{len(sizes)} kernel call(s), batch sizes "
                        f"mean {mean:.1f} / max {max(sizes)}")
        return "; ".join(bits)


@dataclass
class ServingPoint:
    """One point of a serving DSE (:meth:`repro_torch.api.Job.sweep`): a
    generation length + pool partition + per-pool parallelization,
    scored by end-to-end tokens/s (``result`` is the evaluated
    :class:`~repro_torch.core.serving.JobResult`)."""
    out_tokens: int
    split: tuple                     # (world,) colocated | (wp, wd)
    prefill_cfg: ParallelCfg
    decode_cfg: ParallelCfg
    result: object
    resilience: object = None        # worst-pool ft.ResilienceReport

    @property
    def tokens_per_s(self) -> float:
        return self.result.tokens_per_s

    @property
    def goodput(self) -> float:
        return self.resilience.goodput if self.resilience else 1.0

    @property
    def effective_tokens_per_s(self) -> float:
        """Delivered tokens/s once failure downtime is charged (both
        pools stall while either recovers — the request pipeline is
        synchronous across the handoff)."""
        return self.tokens_per_s * self.goodput

    def row(self) -> dict:
        split = "colocated" if len(self.split) == 1 \
            else f"{self.split[0]}+{self.split[1]}"
        out = {"out_tokens": self.out_tokens, "split": split,
               "prefill": self.prefill_cfg.describe(),
               "decode": self.decode_cfg.describe(),
               **self.result.row()}
        if self.resilience is not None:
            out["eff_tokens_per_s"] = round(self.effective_tokens_per_s, 1)
            out.update(self.resilience.row())
        return out


def enumerate_pool_splits(world: int) -> list[tuple[int, int]]:
    """Candidate ``(prefill_world, decode_world)`` partitions of a
    serving cluster: every power-of-two prefill share (decode gets the
    remainder) — the Table IX observation is that the two phases prefer
    different cluster sizes, so the split is a genuine DSE dimension."""
    if world < 2:
        raise InfeasibleConfigError(
            f"disaggregated serving needs world >= 2 devices (one per "
            f"pool), got world={world}; run colocated or grow the cluster")
    splits = []
    p = 1
    while p < world:
        splits.append((p, world - p))
        p *= 2
    return splits


def _pow2_divisors(n: int) -> list[int]:
    out = [1]
    while out[-1] * 2 <= n:
        out.append(out[-1] * 2)
    return [d for d in out if n % d == 0]


def enumerate_configs(world: int, *, max_tp: int = 64, max_pp: int = 64,
                      max_cp: int = 64, with_fsdp: bool = True,
                      ep: Optional[int] = None,
                      microbatches=1,
                      schedule="1f1b", vstages: int = 1,
                      placements: Optional[Iterable] = None
                      ) -> Iterable[ParallelCfg]:
    """All (dp, tp, cp, pp) power-of-two factorizations of ``world``.

    ``schedule`` may be a single name or an iterable of names from
    :data:`repro_torch.core.schedules.SCHEDULES` — the latter makes the
    pipeline schedule one more swept dimension (each factorization is
    enumerated once per schedule).  ``vstages`` applies to interleaved
    points (other schedules have no chunking).  ``microbatches`` may
    likewise be a single count or an iterable of counts — the batched
    backend evaluates the whole mb dimension in one kernel at pp = 1,
    and branch-and-bound prunes it from closed-form step predictions.

    ``placements`` makes the axis *placement* a swept dimension: each
    entry is an axis order (innermost first, e.g. ``("tp", "dp", "pp")``)
    projected onto every factorization via
    :func:`repro_torch.core.topology.normalize_placement`; orders that
    coincide after projection (an axis absent from the factorization)
    are deduplicated.  Placement changes collective *time* on a
    topology-aware profile, never bytes."""
    scheds = (schedule,) if isinstance(schedule, str) else tuple(schedule)
    mbs = ((microbatches,) if isinstance(microbatches, int)
           else tuple(microbatches))
    place_opts = (None,) if placements is None else tuple(
        tuple(p) for p in placements)
    for tp in _pow2_divisors(world):
        if tp > max_tp:
            continue
        for cp in _pow2_divisors(world // tp):
            if cp > max_cp:
                continue
            for pp in _pow2_divisors(world // (tp * cp)):
                if pp > max_pp:
                    continue
                dp = world // (tp * cp * pp)
                fsdp_opts = (False, True) if (with_fsdp and dp > 1) else (False,)
                for fsdp in fsdp_opts:
                    axes = {}
                    if dp > 1:
                        axes["dp"] = dp
                    if tp > 1:
                        axes["tp"] = tp
                    if cp > 1:
                        axes["cp"] = cp
                    if ep and dp % ep == 0 and dp > 1:
                        pass  # EP reuses the dp axis (tokens<->experts A2A)
                    # schedules only differentiate pipelined points
                    for sched in (scheds if pp > 1 else scheds[:1]):
                        for mb in mbs:
                            seen_places = set()
                            for place in place_opts:
                                if place is not None:
                                    place = normalize_placement(place, axes)
                                    # degree-1 axes don't stride the grid:
                                    # orders differing only in where "pp"
                                    # sits are physically identical at pp=1
                                    key = tuple(a for a in place
                                                if a != "pp" or pp > 1)
                                    if key in seen_places:
                                        continue
                                    seen_places.add(key)
                                yield ParallelCfg(
                                    axes=axes,
                                    dp_axis="dp" if dp > 1 else None,
                                    tp_axis="tp" if tp > 1 else None,
                                    sp=tp > 1,
                                    cp_axis="cp" if cp > 1 else None,
                                    ep_axis="dp" if (ep and dp > 1) else None,
                                    fsdp=fsdp, pp=pp,
                                    microbatches=mb,
                                    schedule=sched,
                                    vstages=(vstages if sched == "interleaved"
                                             else 1),
                                    placement=place or ())


def evaluate_point(build: Callable[[], tuple], cfg: ParallelCfg, env: Env,
                   hw: HardwareProfile = TPU_V5E, *, n_layers: int,
                   recompute: bool = False, name: str = "dse",
                   algorithms: Optional[dict] = None) -> DSEPoint:
    """Reference (sympy) backend: run the full STAGE pipeline for one
    config.  ``build`` must return a fresh (GraphBuilder-owned) Graph
    each call (graphs are mutated)."""
    graph = build()
    distribute(graph, cfg, env)
    plan = apply_pipeline(graph, cfg.pp, n_layers, vstages=cfg.vstages)
    w = instantiate(graph, cfg, env, plan, name=f"{name}/{cfg.describe()}")
    sim = simulate(w, hw, recompute=recompute, algorithms=algorithms)
    mem = peak_memory(graph, cfg, env, plan, recompute=recompute)
    return DSEPoint(cfg=cfg, sim=sim, mem=mem, label=cfg.describe())


def evaluate_point_compiled(engine: CompiledBackend, cfg: ParallelCfg,
                            hw: HardwareProfile = TPU_V5E, *,
                            recompute: bool = False, name: str = "dse",
                            reuse: bool = False,
                            algorithms: Optional[dict] = None) -> DSEPoint:
    """Compiled backend: numeric replay of the config's structure class.

    ``reuse=True`` recycles the program's scratch workload between
    points (scratch is keyed per thread, so concurrent serial sweeps
    sharing one engine stay isolated)."""
    prog = engine.program(cfg)
    w = prog.instantiate(cfg, name=f"{name}/{cfg.describe()}", reuse=reuse)
    sim = simulate(w, hw, recompute=recompute, algorithms=algorithms)
    mem = prog.peak_memory(cfg, recompute=recompute)
    return DSEPoint(cfg=cfg, sim=sim, mem=mem, label=cfg.describe())


def _skip(cfg: ParallelCfg, exc: BaseException, *, prefiltered: bool = False,
          verify: bool = False) -> SkippedConfig:
    """Record one infeasible config; with ``verify`` attach a structured
    :class:`repro_torch.analysis.Diagnostic` (code ``STG007``) so downstream
    tooling can filter skips by rule instead of parsing reason strings."""
    sk = SkippedConfig(cfg, f"{type(exc).__name__}: {exc}",
                       prefiltered=prefiltered)
    if verify:
        from ..analysis.diagnostics import INFEASIBLE_CONFIG, Report
        rep = Report()
        rep.add(INFEASIBLE_CONFIG, str(exc), node=cfg.describe(),
                fixit="adjust microbatches / schedule to fit the workload")
        sk.diagnostics = rep.diagnostics
    return sk


def evaluate_or_skip(cfg: ParallelCfg, *, env: Env, hw: HardwareProfile,
                     n_layers: int, name: str,
                     engine: Optional[CompiledBackend] = None,
                     build: Optional[Callable] = None,
                     recompute: bool = False,
                     mem_limit_gb: Optional[float] = None,
                     reuse: bool = False,
                     algorithms: Optional[dict] = None,
                     verify: bool = False):
    """One sweep point, shared by every execution mode (serial, thread
    chunks, process chunks): returns a :class:`DSEPoint` (OOM-labelled
    when over ``mem_limit_gb``) or a :class:`SkippedConfig` when the
    factorization is infeasible.  Exactly one of ``engine`` (compiled)
    or ``build`` (sympy reference) must be provided.

    Before evaluating, the microbatching is checked against the bound
    workload (``microbatches`` must divide the per-dp-rank batch;
    interleaved schedules need ``microbatches % pp == 0``) so fractional
    microbatch work is skipped-with-reason rather than silently scored."""
    try:
        cfg.validate_workload(batch=env.get(sym("B")))
        if engine is not None:
            pt = evaluate_point_compiled(engine, cfg, hw,
                                         recompute=recompute, name=name,
                                         reuse=reuse, algorithms=algorithms)
        else:
            pt = evaluate_point(build, cfg, env, hw, n_layers=n_layers,
                                recompute=recompute, name=name,
                                algorithms=algorithms)
    except InfeasibleConfigError as e:
        return _skip(cfg, e, verify=verify)
    if mem_limit_gb is not None and pt.peak_gb > mem_limit_gb:
        pt.label += " (OOM)"
    return pt


RANK_MODES = ("step_time", "effective_goodput")
SEARCH_MODES = ("full", "pareto", "bnb")


def _objective(p: DSEPoint) -> tuple:
    """The sweep's multi-objective vector: latency, footprint, and
    goodput-deflated latency (== step_ms when no resilience spec)."""
    return (p.step_ms, p.peak_gb, p.effective_step_ms)


def _dominates(a: tuple, b: tuple) -> bool:
    """Strict Pareto domination: <= everywhere, < somewhere."""
    return a != b and a[0] <= b[0] and a[1] <= b[1] and a[2] <= b[2]


def pareto_front(points: list) -> list:
    """Non-dominated subset over (step_ms, peak_gb, effective_step_ms).

    Exact objective ties are ALL kept (neither dominates), so front
    membership is deterministic under backend-identical re-evaluation.
    Candidates are processed in lexicographic objective order — any
    dominator sorts strictly earlier, so the running front is the exact
    front of the processed prefix and each candidate only scans the
    (small) current front.  Input order is preserved in the output."""
    objs = [_objective(p) for p in points]
    order = sorted(range(len(points)), key=objs.__getitem__)
    front: list[int] = []
    for i in order:
        if not any(_dominates(objs[j], objs[i]) for j in front):
            front.append(i)
    front.sort()
    return [points[i] for i in front]


class _Archive:
    """Running Pareto archive of evaluated objective vectors (the BnB
    incumbent set), kept reduced to its own front: if ANY evaluated
    point strictly dominates a candidate's bound vector, some front
    member does too (domination is transitive)."""

    def __init__(self):
        self.front: list[tuple] = []

    def add(self, obj: tuple) -> None:
        if obj in self.front or any(_dominates(f, obj) for f in self.front):
            return
        self.front = [f for f in self.front if not _dominates(obj, f)]
        self.front.append(obj)

    def prunes(self, lb: tuple) -> bool:
        return any(_dominates(f, lb) for f in self.front)


def _cell_floor(prog, cfg0: ParallelCfg, hw: HardwareProfile,
                recompute: bool, comm_ok: bool) -> tuple:
    """Closed-form step lower-bound pieces for one BnB cell:
    ``(M, path, O)`` seconds, all monotone consequences of the cost
    program with no scheduling.

    * ``M`` — max over pipeline stages of per-stream microbatch-phase
      busy time: every schedule runs each stage's ``mb`` slot copies
      serially per stream, so ``makespan >= mb * M``.
    * ``path`` — single-microbatch critical path: microbatch 1's fwd
      chunk slots chain stage-to-stage and its bwd slots chain back, and
      each slot's span is >= both of its stream busy times, so
      ``makespan >= sum_c max-stream(fwd_c) + max-stream(bwd_c)``.
      Sound for the replay schedules (gpipe / 1f1b / interleaved) where
      a whole chunk slot is a dependency unit; zb-h1 splits weight-grad
      work off the chain, so callers must not apply it there.
    * ``O`` — max over stages of per-stream optimizer busy time
      (``step = makespan + max_s opt_span_s >= makespan + O``).

    The comm stream is only counted (``comm_ok``) on flat profiles
    without per-collective algorithm overrides, where the default
    lowering is exact; otherwise comm >= 0 is all the bound uses,
    keeping it sound for ANY topology, algorithm, or placement."""
    mesh = cfg0.mesh
    ln, lb = prog._local(cfg0)
    lay = prog._layout(max(1, cfg0.pp), getattr(cfg0, "vstages", 1))
    peak, hbm, eff = hw.peak_flops, hw.hbm_bw, hw.efficiency
    lat = hw.link_latency
    comp_s: dict = {}
    comm_s: dict = {}
    oc_s: dict = {}
    om_s: dict = {}
    fpc: dict = {}
    fpm: dict = {}
    bpc: dict = {}
    bpm: dict = {}
    bump = lambda d, k, v: d.__setitem__(k, d.get(k, 0.0) + v)  # noqa: E731
    for e in lay.entries:
        cm, ph, s, ch = e[11], e[4], e[5], e[6]
        if cm is not None:
            if not comm_ok:
                continue
            if cm[0] == "SendRecv":
                bw = hw.link_bw_axis.get("pp", hw.link_bw)
                d = lb[cm[1]] / bw + lat
            else:
                coll, axis, ref, other = cm
                n = mesh[axis]
                if n <= 1:
                    continue
                full = prog._gb[ref]
                for a in other:
                    full /= mesh[a]
                size = full if coll in _PER_RANK_COLLS else full / n
                wire, steps = collective_wire(coll, size, n)
                bw = hw.link_bw_axis.get(axis, hw.link_bw)
                d = wire / bw + steps * lat
            if ph == "opt":
                bump(om_s, s, d)
            else:
                bump(comm_s, s, d)
                bump(fpm if ph == "fwd" else bpm, ch, d)
            continue
        flop = e[8]
        if flop is None:
            flops = 0.0
        elif flop[0] == "scale":
            flops = flop[1] * ln[flop[2]]
        else:
            flops = 2.0
            for fval, axs in prog._eins_f[flop[1]]:
                deg = 1
                for a in axs:
                    deg *= mesh[a]
                flops *= fval / deg
        ba = 0.0
        for t in e[9]:
            ba += lb[t]
        d = max(flops / (peak * eff.get(e[3], 0.9)) if flops else 0.0,
                ba / hbm)
        if ph == "opt":
            bump(oc_s, s, d)
        elif ph == "fwd":
            bump(comp_s, s, d)
            bump(fpc, ch, d)
            if recompute:                       # extras replay in bwd slots
                bump(comp_s, s, d)
                bump(bpc, ch, d)
        else:
            bump(comp_s, s, d)
            bump(bpc, ch, d)
    stages = set(comp_s) | set(comm_s)
    M = max((max(comp_s.get(s, 0.0), comm_s.get(s, 0.0)) for s in stages),
            default=0.0)
    ostages = set(oc_s) | set(om_s)
    O = max((max(oc_s.get(s, 0.0), om_s.get(s, 0.0)) for s in ostages),
            default=0.0)
    chunks = set(fpc) | set(fpm) | set(bpc) | set(bpm)
    path = sum(max(fpc.get(c, 0.0), fpm.get(c, 0.0))
               + max(bpc.get(c, 0.0), bpm.get(c, 0.0)) for c in chunks)
    return M, path, O


def step_lower_bound(cfg: ParallelCfg, floor: tuple) -> float:
    """Per-config step-time lower bound from a cell's floor pieces:
    ``max(mb * M, path) + O`` seconds.

    The chunk-chain path bound only holds where a whole chunk slot is
    the dependency unit — zb-h1 splits weight-grads off the chain, so
    pipelined zb-h1 points use the busy bound alone.  Module-level (not
    a closure) so the static prover can certify exactly the formula the
    search applies (``repro_torch.analysis.prover``, rule STG605)."""
    m, path, o = floor
    lb = cfg.microbatches * m
    if cfg.schedule != "zb-h1" or max(1, cfg.pp) <= 1:
        lb = max(lb, path)
    return lb + o


def branch_and_bound(engine: CompiledBackend, cfgs: list,
                     hw: HardwareProfile, *, recompute: bool = False,
                     name: str = "dse", algorithms: Optional[dict] = None,
                     verify: bool = False,
                     mem_limit_gb: Optional[float] = None,
                     resilience=None,
                     progress: "Optional[_Progress]" = None,
                     certificates=None
                     ) -> tuple[list, list, int]:
    """Pruned search over the config lattice; returns
    ``(evaluated points, skipped, visited)`` with the exhaustive Pareto
    front guaranteed to be a subset of the evaluated points.

    Configs are bucketed into *cells* — one (structure class, mesh
    degrees, pp, vstages) each — and cells are visited in ascending
    order of their closed-form step floor so strong incumbents enter the
    archive early.  A candidate is pruned when an already-evaluated
    point strictly dominates its bound vector
    ``(step_floor, peak_gb, step_floor)``:

    * step floor — :func:`_cell_floor` busy/critical-path pieces:
      ``max(mb * stage-busy-max, single-mb chunk path) + opt-busy-max``;
      schedule bubbles, exposed comm, and stream serialization only add.
    * peak_gb — the compiled memory model is closed-form per config (no
      instantiate/simulate), so the memory coordinate is EXACT.
    * effective floor — goodput <= 1, so effective step >= step.

    Strict domination of a lower bound implies strict domination of the
    true vector, so no exhaustive-front point is ever pruned (ties are
    never pruned); ``visited`` counts full evaluations only (the memory
    model runs per candidate — that is the closed-form piece the search
    is allowed to consult for free)."""
    cells: dict = {}
    order: list = []
    skipped: list = []
    for cfg in cfgs:
        try:
            prog = engine.program(cfg)
        except InfeasibleConfigError as e:
            _log.debug("bnb skipped %s: %s", cfg.describe(), e)
            skipped.append(_skip(cfg, e, verify=verify))
            if progress is not None:
                progress.tick(skipped=1)
            continue
        key = (id(prog), tuple(sorted(cfg.axes.items())), max(1, cfg.pp),
               getattr(cfg, "vstages", 1))
        if key not in cells:
            cells[key] = (prog, [])
            order.append(key)
        cells[key][1].append(cfg)

    comm_ok = (algorithms is None
               and getattr(hw, "topology", None) is None)
    plan = []
    for key in order:
        prog, cell = cells[key]
        floor = _cell_floor(prog, cell[0], hw, recompute, comm_ok)
        slb_min = min(c.microbatches for c in cell) * floor[0] + floor[2]
        plan.append((slb_min, key, floor))
    plan.sort(key=lambda x: x[0])

    # Structure classes carrying a memory-monotonicity certificate
    # (peak memory non-increasing in every mesh degree, proved by
    # repro_torch.analysis.prover) may be pruned from a *lower bound* on
    # memory — the exact peak of any already-seen config of the same
    # class whose degrees are componentwise >= the candidate's (and,
    # when the space's inflight factors are certified non-decreasing in
    # mb, whose microbatch count is <=) — before the closed-form memory
    # model is even consulted.  Since the bound is <= the exact value,
    # strict domination of the bound vector implies strict domination
    # of the exact one: the front and the visited count are provably
    # identical to the uncertified search.
    mono_ids = (certificates.memory_monotone_programs()
                if certificates is not None else frozenset())
    mb_mono = bool(certificates is not None
                   and getattr(certificates, "inflight_monotone", False))
    mem_memo: dict = {}

    archive = _Archive()
    points: list[DSEPoint] = []
    visited = 0
    for _slb, key, floor in plan:
        prog, cell = cells[key]
        axis_names = tuple(a for a, _ in key[1])
        for cfg in sorted(cell, key=lambda c: c.microbatches):
            slb_ms = step_lower_bound(cfg, floor) * 1e3
            degs = tuple(cfg.axes.get(a, 1) for a in axis_names)
            mb = cfg.microbatches
            mkey = (key[0], key[2], key[3], cfg.schedule)
            if id(prog) in mono_ids:
                lb_mem = max((m for dg, mbe, m in mem_memo.get(mkey, ())
                              if (mbe == mb or (mb_mono and mbe <= mb))
                              and all(x >= y for x, y in zip(dg, degs))),
                             default=None)
                if (lb_mem is not None
                        and archive.prunes((slb_ms, lb_mem, slb_ms))):
                    _metrics.counter("dse.bnb_cert_pruned").inc()
                    if progress is not None:
                        progress.tick()
                    continue
            mem_gb = prog.peak_memory(cfg, recompute=recompute).peak_gb
            if id(prog) in mono_ids:
                mem_memo.setdefault(mkey, []).append((degs, mb, mem_gb))
            if archive.prunes((slb_ms, mem_gb, slb_ms)):
                _metrics.counter("dse.bnb_pruned").inc()
                if progress is not None:
                    progress.tick()
                continue
            visited += 1
            try:
                pt = evaluate_point_compiled(engine, cfg, hw,
                                             recompute=recompute,
                                             name=name, reuse=True,
                                             algorithms=algorithms)
            except InfeasibleConfigError as e:
                _log.debug("bnb skipped %s: %s", cfg.describe(), e)
                skipped.append(_skip(cfg, e, verify=verify))
                if progress is not None:
                    progress.tick(skipped=1)
                continue
            if resilience is not None:
                score_resilience([pt], resilience, hw)
            if mem_limit_gb is not None and pt.peak_gb > mem_limit_gb:
                pt.label += " (OOM)"
            points.append(pt)
            archive.add(_objective(pt))
            if progress is not None:
                progress.tick()
    return points, skipped, visited


def score_resilience(points: list[DSEPoint], resilience, hw) -> None:
    """Attach a :class:`repro_torch.ft.ResilienceReport` to every point (in
    place): failure model from the profile's topology, checkpoint cost
    from each point's own memory report, recovery path from its dp
    replication.  Shared by the thread and process sweep paths so both
    rank identically."""
    from ..ft.goodput import score_point
    for p in points:
        p.resilience = score_point(p.cfg, p.sim, p.mem, resilience, hw)


def rank_points(points: list[DSEPoint], rank_by: str) -> None:
    """Sort sweep points (in place) by the requested objective.
    ``effective_goodput`` ranks by goodput-deflated step time — useful
    wall seconds per step — so it needs points already scored by
    :func:`score_resilience`."""
    if rank_by not in RANK_MODES:
        raise ValueError(f"rank_by {rank_by!r} not in {RANK_MODES}")
    if rank_by == "effective_goodput":
        if any(p.resilience is None for p in points):
            raise ValueError(
                "rank_by='effective_goodput' needs a resilience spec "
                "(pass resilience=ResilienceSpec(...) to the sweep)")
        points.sort(key=lambda p: p.effective_step_time)
    else:
        points.sort(key=lambda p: p.sim.step_time)


def sweep(build: Callable[[], tuple], env: Env, world: int,
          hw: HardwareProfile = TPU_V5E, *, n_layers: int,
          mem_limit_gb: Optional[float] = None,
          recompute: bool = False, name: str = "dse",
          backend: str = "compiled", engine: Optional[CompiledBackend] = None,
          workers: int = 0, chunk_size: int = 16,
          algorithms: Optional[dict] = None,
          verify: bool = False,
          rank_by: str = "step_time",
          resilience=None,
          search: str = "full",
          progress: Optional[Callable] = None,
          prove: bool = False,
          device=None,
          **enum_kw) -> SweepResult:
    """Evaluate every enumerated strategy; see module docstring.

    ``progress`` is called as ``progress(done, total, skipped, eta)``
    after every resolved config (done counts both evaluated and skipped;
    eta is the remaining-seconds estimate, ``None`` before the first
    completion) — from worker threads on the threaded path, so callbacks
    must be thread-safe.

    ``workers`` > 1 evaluates config chunks on a thread pool (results
    are identical and identically ordered to the serial run); ``engine``
    lets callers share a pre-warmed :class:`CompiledBackend` across
    sweeps (what :meth:`repro_torch.api.Scenario.sweep` does).

    ``backend="batched"`` evaluates whole structure classes at once on
    the card (:mod:`repro_torch.core.batched`, on ``device``: the CUDA
    device unless ``device="cpu"``); configs the
    batched kernels cannot replay (zb-h1, topology profiles, explicit
    collective-algorithm overrides) transparently fall back to the
    per-config compiled path, so results match ``backend="compiled"``
    to float64 accuracy with identical ordering.

    ``search`` selects what the sweep returns: ``"full"`` (default) all
    feasible points ranked; ``"pareto"`` only the Pareto front over
    (step_ms, peak_gb, effective_step_ms) after evaluating everything;
    ``"bnb"`` the same exact front found by branch-and-bound over the
    config lattice, pruning subtrees whose closed-form lower bounds are
    already strictly dominated — typically evaluating a small fraction
    of the space (``SweepResult.visited`` / ``.total``).

    Configs that fail the cheap workload-shape feasibility check are
    pruned *before* dispatch (never hitting the executor) and recorded
    on ``SweepResult.skipped`` with ``prefiltered=True``;
    ``SweepResult.pruned`` tallies why.  ``verify=True`` additionally
    attaches structured :class:`repro_torch.analysis.Diagnostic` records to
    every skipped config.

    ``resilience`` (a :class:`repro_torch.ft.ResilienceSpec`) scores every
    feasible point's goodput under failures; ``rank_by=
    "effective_goodput"`` then ranks by goodput-deflated step time
    instead of raw step time — dp-replicated configs recover from peers
    while tp*pp-heavy ones rewind to storage, so the two rankings can
    disagree.  With the default ``rank_by="step_time"`` and no spec the
    sweep is bit-identical to before.

    ``prove=True`` runs the symbolic invariant prover
    (:func:`repro_torch.analysis.prover.prove_space`) over every structure
    class the enumeration touches *before* evaluating anything, attaches
    the resulting :class:`~repro_torch.analysis.prover.SpaceCertificate` to
    ``SweepResult.certificates``, and — under ``search="bnb"`` — feeds
    the memory-monotonicity certificates to the search so provably
    dominated candidates are pruned without consulting the memory model.
    """
    if backend not in ("compiled", "sympy", "batched"):
        raise ValueError(
            f"backend {backend!r} not in compiled|sympy|batched")
    if search not in SEARCH_MODES:
        raise ValueError(f"search {search!r} not in {SEARCH_MODES}")
    if search == "bnb" and backend == "sympy":
        raise ValueError("search='bnb' needs the compiled cost model "
                         "(backend='compiled' or 'batched')")
    if rank_by not in RANK_MODES:
        raise ValueError(f"rank_by {rank_by!r} not in {RANK_MODES}")
    if rank_by == "effective_goodput" and resilience is None:
        raise ValueError(
            "rank_by='effective_goodput' requires resilience=ResilienceSpec")
    cfgs = list(enumerate_configs(world, **enum_kw))
    bengine = None
    if backend == "batched":
        from .batched import BatchedBackend
        if isinstance(engine, BatchedBackend):
            bengine, engine = engine, engine.engine
        else:
            if engine is None:
                engine = CompiledBackend(build, env, n_layers=n_layers)
            bengine = BatchedBackend(engine, device=device)
    elif backend == "compiled" and engine is None:
        engine = CompiledBackend(build, env, n_layers=n_layers)

    certs = None
    if prove:
        # The prover reads lowered tables, so proving a sympy sweep
        # still compiles each structure class once (evaluation itself
        # stays on the sympy path — `engine` is left None there).
        pengine = engine or CompiledBackend(build, env, n_layers=n_layers)
        from ..analysis.prover import prove_space
        certs = prove_space(pengine, cfgs=cfgs, hw=hw, recompute=recompute,
                            name=name)

    # cheap pre-dispatch feasibility pass: infeasible factorizations are
    # counted and skipped-with-reason without consuming executor slots
    batch = env.get(sym("B"))
    prog_cb = _Progress(progress, len(cfgs))
    prefiltered, feasible = [], []
    for cfg in cfgs:
        try:
            cfg.validate_workload(batch=batch)
        except InfeasibleConfigError as e:
            _log.debug("prefiltered %s: %s", cfg.describe(), e)
            prefiltered.append(_skip(cfg, e, prefiltered=True,
                                     verify=verify))
        else:
            feasible.append(cfg)
    cfgs = feasible
    if prefiltered:
        _log.debug("prefilter dropped %d of %d config(s) before dispatch",
                   len(prefiltered), prog_cb.total)
        _metrics.counter("dse.prefiltered").inc(len(prefiltered))
        prog_cb.tick(n=len(prefiltered), skipped=len(prefiltered))

    serial = not (workers and workers > 1) or backend == "batched"

    def eval_one(cfg: ParallelCfg):
        r = evaluate_or_skip(
            cfg, env=env, hw=hw, n_layers=n_layers, name=name,
            engine=engine, build=build if backend == "sympy" else None,
            recompute=recompute, mem_limit_gb=mem_limit_gb, reuse=serial,
            algorithms=algorithms, verify=verify)
        if isinstance(r, SkippedConfig):
            _log.debug("skipped %s: %s", cfg.describe(), r.reason)
            _metrics.counter("dse.skipped").inc()
        else:
            _metrics.counter("dse.points").inc()
        prog_cb.tick(skipped=1 if isinstance(r, SkippedConfig) else 0)
        return r

    def _stats():
        return {"engine_stats": engine.stats() if engine is not None
                else None,
                "batch_stats": bengine.stats() if bengine is not None
                else None}

    if search == "bnb":
        points, bnb_skips, visited = branch_and_bound(
            engine, cfgs, hw, recompute=recompute, name=name,
            algorithms=algorithms, verify=verify,
            mem_limit_gb=mem_limit_gb, resilience=resilience,
            progress=prog_cb, certificates=certs)
        front = pareto_front(points)
        rank_points(front, rank_by)
        return SweepResult(front, prefiltered + bnb_skips, backend=backend,
                           search="bnb", evaluated=len(points),
                           visited=visited, total=len(cfgs),
                           certificates=certs, **_stats())

    if backend == "batched":
        # Native batched evaluation; configs it cannot replay come back
        # as None and fall through to the per-config compiled path, so
        # result order always matches the serial compiled sweep.
        if algorithms or getattr(hw, "topology", None) is not None:
            native = [None] * len(cfgs)
        else:
            native = bengine.evaluate_many(cfgs, hw, recompute=recompute)
        results = []
        for cfg, r in zip(cfgs, native):
            if r is None:
                results.append(eval_one(cfg))
            else:
                sim, mem = r
                pt = DSEPoint(cfg=cfg, sim=sim, mem=mem,
                              label=cfg.describe())
                if mem_limit_gb is not None and pt.peak_gb > mem_limit_gb:
                    pt.label += " (OOM)"
                results.append(pt)
                _metrics.counter("dse.points").inc()
                prog_cb.tick()
    elif workers and workers > 1 and len(cfgs) > 1:
        chunks = [cfgs[i:i + chunk_size]
                  for i in range(0, len(cfgs), chunk_size)]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = [pool.submit(lambda ch=ch: [eval_one(c) for c in ch])
                    for ch in chunks]
            results = list(itertools.chain.from_iterable(
                f.result() for f in futs))     # enumeration order restored
    else:
        results = [eval_one(cfg) for cfg in cfgs]

    points = [r for r in results if isinstance(r, DSEPoint)]
    skipped = prefiltered + [r for r in results
                             if isinstance(r, SkippedConfig)]
    if resilience is not None:
        score_resilience(points, resilience, hw)
    if search == "pareto":
        evaluated = len(points)
        points = pareto_front(points)
        rank_points(points, rank_by)
        return SweepResult(points, skipped, backend=backend,
                           search="pareto", evaluated=evaluated,
                           total=len(cfgs), certificates=certs, **_stats())
    rank_points(points, rank_by)
    return SweepResult(points, skipped, backend=backend,
                       certificates=certs, **_stats())
