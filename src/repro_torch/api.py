"""Fluent front-door for the STAGE pipeline: ``Scenario`` -> ``Trace``.

The paper's value (§IV, Fig 3) is a staged pipeline — assemble ->
distribute -> pipeline-cut -> instantiate -> {simulate, memory, chakra}
— but wiring it by hand means plumbing mesh axis names through
:class:`~repro_torch.core.distribute.ParallelCfg` and re-assembling the
symbolic graph for every parallel config even though assembly only
depends on ``(spec, mode)``.  This module packages the pipeline behind
two objects:

* :class:`Scenario` — an immutable builder describing WHAT to model:
  the target :class:`~repro_torch.core.assemble.ModelSpec`, the workload shape
  (``.train(batch=64, seq=2048)`` / ``.serve(batch=8, kv_len=4096)``)
  and the parallelization (``.parallel(dp=8, tp=4, pp=2, fsdp=True)``
  — mesh and axis names are constructed for you).

* :class:`Trace` — a lazy handle over one scenario's generated pipeline:
  ``.workload``, ``.graph``, ``.plan``, ``.env`` materialize on first
  access and everything downstream (``.simulate(hw)``, ``.memory()``,
  ``.export_chakra(dir)``, ``.op_counts()``) is memoized.

Assembled symbolic graphs are cached process-wide per ``(spec, mode)``
and every trace/config receives its own mutable
:meth:`~repro_torch.core.stg.Graph.clone` (distribution mutates in place).
:meth:`Scenario.sweep` — the DSE entrypoint replacing
``dse.enumerate_configs`` + a manual loop — therefore performs exactly
one symbolic assembly per mode for the whole sweep (Fig 8/13 hot path).

    from repro_torch import Scenario, TPU_V5E

    trace = (Scenario(spec)
             .train(batch=64, seq=2048)
             .parallel(dp=8, tp=4, sp=True, zero1=True)
             .trace())
    trace.op_counts()            # Table VI per-GPU op counts
    trace.simulate(TPU_V5E).ms   # analytic step time
    trace.memory().peak_gb       # Table V peak memory
    points = Scenario(spec).train(batch=64, seq=2048).sweep(world=64)

Own copy of ``repro.api``.  ``backend="batched"`` sweeps run on the card
(``device``: the CUDA device unless the caller passes ``"cpu"``) through the
``cost_reduce`` kernel.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional

from .core.assemble import ModelSpec, bind_env, build_graph, total_layers
from .core.chakra import export_ranks, export_stage
from .core.compiled import CompiledBackend
from .core.costmodel import HardwareProfile, TPU_V5E
from .core.distribute import DistReport, ParallelCfg, distribute
from .core.dse import DSEPoint, SweepResult
from .core.dse import sweep as dse_sweep
from .core.graphdist import PipelinePlan, apply_pipeline
from .core.instantiate import Workload, instantiate
from .core.memory import MemoryReport, peak_memory
from .core.simulate import SimResult, simulate
from .core.matcher import InfeasibleConfigError
from .core.serving import DecodeSeries, JobResult, PhaseResult
from .core.stg import Graph, GraphBuilder
from .core.symbolic import Env
from .core.topology import ClusterTopology, normalize_placement
from .ft.goodput import ResilienceSpec
from .obs.spans import span as _span

__all__ = ["Scenario", "Trace", "Phase", "Job", "graph_cache_stats",
           "clear_graph_cache", "compiled_cache_stats"]


# --------------------------------------------------------------------------
# Process-wide cache of pristine assembled graphs
# --------------------------------------------------------------------------

class _GraphCache:
    """LRU of pristine (never-distributed) builders keyed by (spec, mode).

    ModelSpec is a frozen dataclass (hashable), so the key is the full
    model description; entries are handed out only as clones."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.builds = 0          # cold assemblies (the Scenario.sweep spy)
        self.hits = 0
        self.evictions = 0

    def builder(self, spec: ModelSpec, mode: str) -> GraphBuilder:
        key = (spec, mode)
        with self._lock:
            hit = self._store.get(key)
            if hit is not None:
                self._store.move_to_end(key)
                self.hits += 1
                return hit
        built = build_graph(spec, mode=mode)
        with self._lock:
            self.builds += 1
            self._store[key] = built
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)
                self.evictions += 1
        return built

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.builds = 0
            self.hits = 0
            self.evictions = 0


_cache = _GraphCache()


class _EngineCache:
    """Process-wide :class:`~repro_torch.core.compiled.CompiledBackend` cache.

    Keyed by ``(spec, mode, env signature)`` — one numeric engine (and
    its structure classes) per distinct workload binding, shared between
    every Trace and sweep that evaluates it."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.builds = 0
        self.cache_hits = 0
        self.evictions = 0

    def engine(self, spec: ModelSpec, mode: str, env: Env) -> CompiledBackend:
        key = (spec, mode, env.signature())
        with self._lock:
            hit = self._store.get(key)
            if hit is not None:
                self._store.move_to_end(key)
                self.cache_hits += 1
                return hit
            src = _cache.builder(spec, mode)
            eng = CompiledBackend(lambda: src.clone().graph, env,
                                  n_layers=total_layers(spec))
            self.builds += 1
            self._store[key] = eng
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)
                self.evictions += 1
            return eng

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.builds = 0
            self.cache_hits = 0
            self.evictions = 0


_engines = _EngineCache()


class _BatchedEngineCache:
    """Process-wide :class:`~repro_torch.core.batched.BatchedBackend` cache.

    Keyed like :class:`_EngineCache` plus the device the engine runs on,
    and wrapping its compiled engine for the same workload key, so
    structure classes (and their batch kernels) are shared across every
    ``backend="batched"`` sweep of the same workload binding on the same
    device — an engine built for the CPU is never replayed on the card,
    nor the other way round.  LRU-bounded like the other caches — batch
    kernels hold device constants, so unbounded growth would pin
    memory across a long interactive DSE session."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.builds = 0
        self.cache_hits = 0
        self.evictions = 0        # LRU pressure: a DIFFERENT key pushed out
        self.stale_rewraps = 0    # same key, underlying compiled engine
        #                           changed (e.g. clear_graph_cache or LRU
        #                           churn in _EngineCache re-built the base):
        #                           the wrapper is re-created in place

    def engine(self, spec: ModelSpec, mode: str, env: Env, device=None):
        from ._device import resolve_device
        from .core.batched import BatchedBackend
        device = resolve_device(device)
        key = (spec, mode, env.signature(), str(device))
        base = _engines.engine(spec, mode, env)
        with self._lock:
            hit = self._store.get(key)
            if hit is not None:
                if hit.engine is base:
                    self._store.move_to_end(key)
                    self.cache_hits += 1
                    return hit
                # staleness guard: the wrapped engine no longer matches
                # the live compiled engine for this key — re-wrap, and
                # count it as such (NOT as an eviction: the slot is
                # reused, nothing else leaves the cache)
                self.stale_rewraps += 1
            else:
                self.builds += 1
            eng = BatchedBackend(base, device=device)
            self._store[key] = eng
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)
                self.evictions += 1
            return eng

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.builds = 0
            self.cache_hits = 0
            self.evictions = 0
            self.stale_rewraps = 0


_batched_engines = _BatchedEngineCache()


def _cfg_key(cfg: ParallelCfg) -> tuple:
    """Hashable identity of a full parallel config (series cache key)."""
    return (tuple(sorted(cfg.axes.items())), cfg.dp_axis, cfg.tp_axis,
            cfg.cp_axis, cfg.ep_axis, cfg.sp, cfg.fsdp, cfg.zero1,
            cfg.pp, cfg.microbatches, cfg.schedule, cfg.vstages,
            cfg.placement)


class _SeriesCache:
    """Process-wide :class:`~repro_torch.core.serving.DecodeSeries` cache.

    Keyed by ``(spec, batch, kv0, cfg)`` — the lowered decode structure
    and its coefficient polynomials are step-count independent, so one
    series serves every ``out_tokens`` value up to its size (a request
    for a longer range rebuilds and replaces the entry)."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.builds = 0
        self.cache_hits = 0
        self.evictions = 0
        self.regrows = 0          # same key rebuilt for a longer range

    def series(self, sc: "Scenario", steps: int) -> DecodeSeries:
        key = (sc.spec, sc.batch, sc.kv_len, _cfg_key(sc.cfg))
        with self._lock:
            hit = self._store.get(key)
            if hit is not None and hit.steps >= steps:
                self._store.move_to_end(key)
                self.cache_hits += 1
                return hit
            if hit is not None:
                self.regrows += 1
            else:
                self.builds += 1
        series = DecodeSeries(
            lambda: _cache.builder(sc.spec, "decode").clone().graph,
            sc.spec, sc.cfg, batch=sc.batch, kv0=sc.kv_len, steps=steps,
            name=f"{sc.spec.name}/decode")
        with self._lock:
            self._store[key] = series
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)
                self.evictions += 1
        return series

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.builds = 0
            self.cache_hits = 0
            self.evictions = 0
            self.regrows = 0


_series = _SeriesCache()


def graph_cache_stats() -> dict:
    """{'size', 'builds', 'hits'} of the process-wide (spec, mode) cache."""
    return {"size": len(_cache._store), "builds": _cache.builds,
            "hits": _cache.hits, "evictions": _cache.evictions}


def compiled_cache_stats() -> dict:
    """Aggregate structure-class stats over all cached compiled engines,
    plus per-cache hit/build/eviction telemetry.

    ``batched_evictions`` (LRU pressure pushed an entry out) and
    ``batched_stale_rewraps`` (the staleness guard re-wrapped a live key
    whose underlying compiled engine changed) are counted DISTINCTLY —
    conflating them hid base-engine churn behind apparent cache
    pressure."""
    with _engines._lock:
        engines = list(_engines._store.values())
    agg = {"engines": len(engines), "classes": 0, "compiles": 0, "hits": 0,
           "batched_engines": len(_batched_engines._store)}
    for e in engines:
        s = e.stats()
        for k in ("classes", "compiles", "hits"):
            agg[k] += s[k]
    agg.update({
        "graph_builds": _cache.builds, "graph_hits": _cache.hits,
        "graph_evictions": _cache.evictions,
        "engine_builds": _engines.builds,
        "engine_hits": _engines.cache_hits,
        "engine_evictions": _engines.evictions,
        "batched_builds": _batched_engines.builds,
        "batched_hits": _batched_engines.cache_hits,
        "batched_evictions": _batched_engines.evictions,
        "batched_stale_rewraps": _batched_engines.stale_rewraps,
        "series_builds": _series.builds, "series_hits": _series.cache_hits,
        "series_evictions": _series.evictions,
        "series_regrows": _series.regrows,
    })
    return agg


def clear_graph_cache() -> None:
    _cache.clear()
    _engines.clear()
    _batched_engines.clear()
    _series.clear()


# --------------------------------------------------------------------------
# Scenario
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Scenario:
    """Immutable description of one STAGE run; fluent methods return
    updated copies, so partial scenarios can be shared and branched."""

    spec: ModelSpec
    mode: str = "train"                     # train | prefill | decode
    batch: int = 1
    seq: int = 1
    kv_len: Optional[int] = None
    cfg: ParallelCfg = field(default_factory=ParallelCfg)
    name: Optional[str] = None
    backend: str = "compiled"               # compiled | sympy
    topology: Optional[ClusterTopology] = None   # hierarchical fabric
    algorithms: tuple = ()                  # ((coll, algo), ...) overrides
    placement_order: tuple = ()             # raw .placement() request
    resilience_spec: Optional[ResilienceSpec] = None

    def __post_init__(self):
        if self.mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode {self.mode!r} not in train|prefill|decode")
        if self.backend not in ("compiled", "sympy", "batched"):
            raise ValueError(
                f"backend {self.backend!r} not in compiled|sympy|batched")

    # ---- workload shape -------------------------------------------------
    def train(self, *, batch: int, seq: int) -> "Scenario":
        """Training step: fwd + bwd + optimizer over [batch, seq] tokens."""
        return replace(self, mode="train", batch=batch, seq=seq, kv_len=None)

    def serve(self, *, batch: int, seq: int = 1,
              kv_len: Optional[int] = None) -> "Scenario":
        """Inference: ``seq == 1`` is a decode step against a ``kv_len``
        cache (kv_len REQUIRED — a decode step without a cache length is
        meaningless, and the historical ``kv = seq`` fallback silently
        modeled a 1-token cache); ``seq > 1`` is prefill (kv_len
        defaults to seq)."""
        mode = "decode" if seq == 1 else "prefill"
        if mode == "decode" and kv_len is None:
            raise ValueError(
                "serve(batch=..., seq=1) is a decode step and requires "
                "kv_len=<context length>; use .prefill(batch=..., seq=...) "
                "for the prompt phase or .decode(batch=..., kv_len=...)")
        return replace(self, mode=mode, batch=batch, seq=seq, kv_len=kv_len)

    def prefill(self, *, batch: int, seq: int) -> "Scenario":
        return self.serve(batch=batch, seq=seq)

    def decode(self, *, batch: int, kv_len: int) -> "Scenario":
        return self.serve(batch=batch, seq=1, kv_len=kv_len)

    # ---- parallelization ------------------------------------------------
    def parallel(self, *, dp: int = 1, tp: int = 1, pp: int = 1, cp: int = 1,
                 ep=False, sp: Optional[bool] = None,
                 fsdp: bool = False, zero1: bool = False,
                 microbatches: int = 1,
                 schedule: Optional[str] = None,
                 vstages: Optional[int] = None) -> "Scenario":
        """Pick a point in the strategy space (paper §II-B / Table III).

        Mesh axes and their names are constructed here — no axis-name
        plumbing.  ``sp`` defaults to on whenever ``tp > 1`` (Megatron
        sequence parallelism); ``ep=True`` routes experts over the dp
        axis (tokens<->experts AllToAll) and ``ep="tp"`` over the tensor
        axis; options whose axis is degenerate (``fsdp``/``zero1``/``ep``
        at degree 1) quietly turn off, which keeps sweep-style
        enumeration free of special cases.  ``schedule``/``vstages``
        select the pipeline schedule (see :meth:`schedule`); left unset
        they inherit whatever an earlier :meth:`schedule` call picked."""
        explicit_vstages = vstages is not None
        if schedule is None:
            schedule = self.cfg.schedule
        if vstages is None:
            vstages = self.cfg.vstages
        axes: dict[str, int] = {}
        if dp > 1:
            axes["dp"] = dp
        if tp > 1:
            axes["tp"] = tp
        if cp > 1:
            axes["cp"] = cp
        ep_axis = None
        if ep:
            ep_axis = ep if isinstance(ep, str) else "dp"
            if ep_axis not in axes:
                ep_axis = None
        cfg = ParallelCfg(
            axes=axes,
            dp_axis="dp" if dp > 1 else None,
            tp_axis="tp" if tp > 1 else None,
            cp_axis="cp" if cp > 1 else None,
            sp=(tp > 1) if sp is None else bool(sp and tp > 1),
            ep_axis=ep_axis,
            fsdp=bool(fsdp and dp > 1),
            zero1=bool(zero1 and dp > 1),
            pp=pp, microbatches=microbatches,
            schedule=schedule,
            # an INHERITED chunking quietly resets when the schedule
            # can't use it; an explicitly passed one goes through so
            # ParallelCfg can reject the contradictory combination
            vstages=vstages if (schedule == "interleaved" or explicit_vstages)
            else 1,
            # an earlier .placement() re-projects onto the new mesh, so
            # the two fluent calls compose in either order
            placement=normalize_placement(self.placement_order, axes)
            if self.placement_order else ())
        return replace(self, cfg=cfg)

    def schedule(self, name: str, *, vstages: Optional[int] = None) -> "Scenario":
        """Select the pipeline schedule replayed by the simulator and
        the memory/Chakra models: ``"gpipe"``, ``"1f1b"`` (default),
        ``"interleaved"`` (Megatron virtual stages —
        ``.schedule("interleaved", vstages=2)``), or ``"zb-h1"``
        (zero-bubble with split backward).  Composable with
        :meth:`parallel` in either order.  Passing ``vstages`` with a
        non-interleaved schedule raises (the combination is
        contradictory, not quietly ignorable)."""
        cfg = replace(self.cfg, schedule=name,
                      vstages=1 if vstages is None else vstages)
        return replace(self, cfg=cfg)

    def cluster(self, topology: ClusterTopology) -> "Scenario":
        """Cost collectives on a hierarchical fabric
        (:class:`~repro_torch.core.topology.ClusterTopology`): every group is
        charged the slowest tier it actually spans under the current
        axis placement.  The scenario's topology is the more specific
        description, so it overrides any topology carried by the profile
        passed to :meth:`Trace.simulate` / :meth:`sweep`."""
        return replace(self, topology=topology)

    def placement(self, *order: str) -> "Scenario":
        """Order the mesh axes on the physical rank grid, innermost
        first (``.placement("tp", "dp", "pp")`` keeps tensor-parallel
        groups inside a node).  Axes absent from the current mesh are
        ignored, omitted ones appended (``"pp"`` outermost by default) —
        so one call composes with any :meth:`parallel` choice (the raw
        order is kept and re-projected when the mesh changes).  Changes
        collective *time* on a topology-aware profile, never bytes."""
        cfg = replace(self.cfg, placement=normalize_placement(
            order, self.cfg.axes))
        return replace(self, cfg=cfg, placement_order=tuple(order))

    def with_algorithm(self, coll: str, algo: str) -> "Scenario":
        """Force a collective algorithm (``.with_algorithm("AllReduce",
        "tree")``) instead of the topology-driven automatic selection —
        see :mod:`repro_torch.core.collectives` for the catalogue."""
        algos = tuple(kv for kv in self.algorithms if kv[0] != coll)
        return replace(self, algorithms=algos + ((coll, algo),))

    def with_cfg(self, cfg: ParallelCfg) -> "Scenario":
        """Escape hatch: adopt a hand-built :class:`ParallelCfg`."""
        return replace(self, cfg=cfg)

    def named(self, name: str) -> "Scenario":
        return replace(self, name=name)

    def with_backend(self, backend: str) -> "Scenario":
        """Select the evaluation backend: ``"compiled"`` (default —
        lambdified numeric cost programs, structure-class cached),
        ``"sympy"`` (the reference per-op substitution path), or
        ``"batched"`` (whole-sweep array replay on the card through the
        ``cost_reduce`` kernel — same single-point behavior as compiled;
        :meth:`sweep` evaluates configs in batches).  All produce
        identical workloads (tests/test_backend_parity.py,
        tests/test_batched_parity.py, tests/test_torch_batched.py)."""
        return replace(self, backend=backend)

    def resilience(self, spec: Optional[ResilienceSpec] = None, *,
                   mtbf=None, ckpt="parallel_fs",
                   interval: Optional[float] = None,
                   recovery: str = "auto", seed: int = 0) -> "Scenario":
        """Attach resilience assumptions (:mod:`repro_torch.ft`): per-domain
        MTBFs (a per-chip float or a ``{"chip"|tier_name: seconds}``
        dict over the cluster topology's tiers), a checkpoint bandwidth
        tier, and the recovery policy.  Downstream, :meth:`sweep` can
        then rank by ``"effective_goodput"`` (step time deflated by
        expected goodput under failures) and :meth:`Trace.export_chakra`
        stamps sampled failure/restore epochs into the traces.  Pass a
        ready :class:`~repro_torch.ft.goodput.ResilienceSpec` or the kwargs to
        build one; ``interval=None`` means the Young-Daly optimum per
        config."""
        if spec is None:
            if mtbf is None:
                raise ValueError(
                    "resilience() needs a ResilienceSpec or mtbf=...")
            spec = ResilienceSpec(mtbf=mtbf, ckpt=ckpt, interval=interval,
                                  recovery=recovery, seed=seed)
        return replace(self, resilience_spec=spec)

    # ---- phase programs -------------------------------------------------
    def phase(self, *, steps: int = 1, kv_growth: int = 0,
              pool: str = "default", name: str = "") -> "Phase":
        """Wrap this scenario as one :class:`Phase` of a phase program
        (``steps`` repetitions; ``kv_growth=1`` advances the KV length
        per step — decode mode only)."""
        return Phase(scenario=self, steps=steps, kv_growth=kv_growth,
                     pool=pool, name=name)

    def generation(self, *, out_tokens: int, batch: Optional[int] = None,
                   seq: Optional[int] = None) -> "Job":
        """A whole generation request as a phase program: prefill the
        ``[batch, seq]`` prompt (emits the first token), then
        ``out_tokens - 1`` decode steps against a KV cache growing from
        ``seq`` — the fluent entry point to the :class:`Job` API; the
        existing one-phase ``.prefill()``/``.decode()`` scenarios are the
        degenerate case.  The prompt shape defaults to the scenario's
        current serving shape (``.prefill(batch=8, seq=1024)
        .generation(out_tokens=512)``); parallelization, topology and
        collective overrides carry over to both phases (colocated —
        see :meth:`Job.disaggregate` for split pools)."""
        if out_tokens < 1:
            raise ValueError(f"out_tokens must be >= 1, got {out_tokens}")
        b = batch if batch is not None else self.batch
        s = seq if seq is not None else (
            self.kv_len if self.mode == "decode" else self.seq)
        if self.mode == "train" and (batch is None or seq is None):
            raise ValueError(
                "generation() needs a serving prompt shape — call "
                ".prefill(batch=..., seq=...) first or pass batch=/seq=")
        if s is None or s < 1:
            raise ValueError(f"prompt length must be >= 1, got {s}")
        phases = [Phase(self.prefill(batch=b, seq=s), steps=1,
                        name="prefill")]
        if out_tokens > 1:
            phases.append(Phase(self.decode(batch=b, kv_len=s),
                                steps=out_tokens - 1, kv_growth=1,
                                name="decode"))
        return Job(phases=tuple(phases), name=self.name or self.spec.name)

    # ---- derived --------------------------------------------------------
    @property
    def world(self) -> int:
        return self.cfg.world

    def env(self) -> Env:
        return bind_env(self.spec, batch=self.batch, seq=self.seq,
                        kv_len=self.kv_len, mode=self.mode)

    def describe(self) -> str:
        return (f"{self.spec.name}/{self.mode} b={self.batch} s={self.seq}"
                + (f" kv={self.kv_len}" if self.kv_len else "")
                + f" [{self.cfg.describe()}]")

    def _effective_hw(self, hw: HardwareProfile) -> HardwareProfile:
        """Overlay the scenario's cluster topology onto the profile —
        the scenario's (more specific) fabric wins over the profile's."""
        if self.topology is not None and hw.topology is not self.topology:
            return hw.with_topology(self.topology)
        return hw

    # ---- pipeline -------------------------------------------------------
    def builder(self) -> GraphBuilder:
        """A private mutable clone of the cached pristine assembly."""
        return _cache.builder(self.spec, self.mode).clone()

    def trace(self) -> "Trace":
        return Trace(self)

    def sweep(self, world: int, hw: HardwareProfile = TPU_V5E, *,
              mem_limit_gb: Optional[float] = None, recompute: bool = False,
              workers: int = 0, executor: str = "thread",
              algorithms: Optional[dict] = None,
              rank_by: str = "step_time",
              resilience: Optional[ResilienceSpec] = None,
              search: str = "full",
              progress: Optional[Callable] = None,
              prove: bool = False,
              device=None,
              **enum_kw) -> SweepResult:
        """One-shot DSE over every strategy for ``world`` devices (Fig 8).

        ``progress`` is invoked as ``progress(done, total, skipped,
        eta)`` as configs resolve — per config on the serial / thread /
        batched paths (from worker threads when threaded: callbacks must
        be thread-safe), per completed chunk on the process executor;
        ``eta`` estimates remaining seconds from the running rate
        (``None`` before the first completion).

        Enumerates power-of-two (dp, tp, cp, pp)[+FSDP] factorizations
        (``enum_kw`` forwards to
        :func:`repro_torch.core.dse.enumerate_configs`: ``max_tp``, ``max_pp``,
        ``max_cp``, ``with_fsdp``, ``ep``, ``microbatches``,
        ``schedule`` — a name or an iterable of names to make the
        pipeline schedule a swept dimension — ``vstages``, and
        ``placements`` — an iterable of axis orders making the physical
        placement a swept dimension on topology-aware profiles),
        evaluates every point, and returns a
        :class:`~repro_torch.core.dse.SweepResult`
        sorted by step time with infeasible factorizations recorded on
        ``.skipped``.  With the default ``backend="compiled"`` the points
        replay lambdified numeric cost programs from the shared
        process-wide engine (one distribute + lowering per structure
        class); ``backend="sympy"`` on the scenario runs the reference
        per-point pipeline.  ``workers`` > 1 evaluates chunks of configs
        concurrently with deterministic result ordering —
        ``executor="thread"`` shares one engine across a thread pool
        (GIL-bound; overlaps little CPU), ``executor="process"`` forks
        workers that each compile their share of structure classes
        (configs are partitioned by structure key, so no class is
        compiled twice; falls back to serial where fork is unavailable).

        ``resilience`` (defaulting to the scenario's
        :meth:`resilience` spec) scores every surviving point with
        expected goodput under failures; ``rank_by="effective_goodput"``
        then orders by ``step_time / goodput`` — peer-recoverable
        (replicated-dp) configs pay no checkpoint/rewind overhead, so
        the resilience-aware winner can differ from the step-time one.

        ``backend="batched"`` (``.with_backend("batched")``) evaluates
        whole structure classes at once on ``device`` (the CUDA device
        unless ``device="cpu"``; without a card that default raises) —
        the ``compiled`` and ``sympy`` backends are host code and ignore
        it;
        ``search="pareto"`` returns only the (step_ms, peak_gb,
        effective_step_ms) Pareto front, and ``search="bnb"`` finds that
        same exact front by branch-and-bound over the config lattice,
        visiting a small fraction of it (``SweepResult.visited``).

        ``prove=True`` statically certifies the whole swept space first
        (see :meth:`prove`), attaches the
        :class:`~repro_torch.analysis.prover.SpaceCertificate` to
        ``SweepResult.certificates``, and lets ``search="bnb"`` prune
        memory-certified classes without evaluating the memory model."""
        env = self.env()
        hw = self._effective_hw(hw)
        if resilience is None:
            resilience = self.resilience_spec
        if self.placement_order and "placements" not in enum_kw:
            # a .placement() on the scenario applies to every swept
            # factorization (pass placements=... to sweep several)
            enum_kw["placements"] = [self.placement_order]
        # per-call overrides stack on the scenario's .with_algorithm()
        # picks, mirroring Trace.simulate(algorithms=...)
        algos = dict(self.algorithms)
        algos.update(algorithms or {})
        if (workers and workers > 1 and executor == "process"
                and self.backend != "batched" and search == "full"):
            return self._sweep_processes(world, hw, env, workers,
                                         mem_limit_gb=mem_limit_gb,
                                         recompute=recompute,
                                         algorithms=algos or None,
                                         rank_by=rank_by,
                                         resilience=resilience,
                                         progress=progress, **enum_kw)
        src = _cache.builder(self.spec, self.mode)      # one assembly/mode
        if self.backend == "batched":
            engine = _batched_engines.engine(self.spec, self.mode, env,
                                             device)
        elif self.backend == "compiled":
            engine = _engines.engine(self.spec, self.mode, env)
        else:
            engine = None
        with _span("scenario.sweep", spec=self.spec.name, world=world,
                   backend=self.backend, search=search):
            return dse_sweep(lambda: src.clone().graph, env, world, hw,
                             n_layers=total_layers(self.spec),
                             mem_limit_gb=mem_limit_gb, recompute=recompute,
                             name=self.spec.name, backend=self.backend,
                             engine=engine, workers=workers,
                             algorithms=algos or None, rank_by=rank_by,
                             resilience=resilience, search=search,
                             progress=progress, prove=prove, **enum_kw)

    def prove(self, world: int, hw: Optional[HardwareProfile] = None, *,
              recompute: bool = False, retrace: bool = True,
              **enum_kw) -> "SpaceCertificate":
        """Statically certify the whole ``world``-device design space —
        no config enumeration beyond the (tiny) degree lattice, no
        simulation (paper Table VII invariants, per structure class).

        Runs the symbolic invariant prover
        (:func:`repro_torch.analysis.prover.prove_space`) over every structure
        class the space touches: FLOP conservation (STG601), comm-volume
        conservation (STG602), guard completeness/disjointness
        (STG603/604), branch-and-bound soundness (STG605), and memory
        monotonicity (STG606).  ``enum_kw`` forwards to
        :func:`repro_torch.core.dse.enumerate_configs`; microbatch, schedule,
        and placement dimensions are stripped — guards never see them,
        so the certificate covers every choice of those for free.
        Returns a :class:`~repro_torch.analysis.prover.SpaceCertificate`
        (``.ok``, ``.summary()``, ``.report``)."""
        from .analysis.prover import prove_space
        env = self.env()
        hw = self._effective_hw(hw or TPU_V5E)
        engine = _engines.engine(self.spec, self.mode, env)
        with _span("scenario.prove", spec=self.spec.name, world=world):
            return prove_space(engine, world=world, hw=hw,
                               recompute=recompute, name=self.spec.name,
                               retrace=retrace, **enum_kw)

    def _sweep_processes(self, world: int, hw: HardwareProfile, env: Env,
                         workers: int, *, mem_limit_gb, recompute,
                         algorithms=None, rank_by="step_time",
                         resilience=None, progress=None,
                         **enum_kw) -> SweepResult:
        import multiprocessing
        import sys
        from concurrent.futures import ProcessPoolExecutor

        from .core.compiled import CompiledBackend
        from .core.dse import (RANK_MODES, _Progress, enumerate_configs,
                               rank_points, score_resilience)

        if rank_by not in RANK_MODES:
            raise ValueError(f"rank_by {rank_by!r} not in {RANK_MODES}")
        if rank_by == "effective_goodput" and resilience is None:
            raise ValueError(
                'rank_by="effective_goodput" needs a resilience spec '
                "(pass resilience=... or set Scenario.resilience(...))")

        # fork is the cheap path (workers inherit the warmed assembly
        # cache), but forking a multithreaded parent can deadlock, and a
        # parent that has initialised CUDA keeps driver threads.  Use
        # spawn in that case (workers re-derive state from the pickled
        # Scenario), and fall back to threads where neither exists.
        method = "fork"
        torch = sys.modules.get("torch")
        if threading.active_count() > 1 or (
                torch is not None and torch.cuda.is_initialized()):
            method = "spawn"
        try:
            ctx = multiprocessing.get_context(method)
        except ValueError:
            return self.sweep(world, hw, mem_limit_gb=mem_limit_gb,
                              recompute=recompute, workers=workers,
                              executor="thread", algorithms=algorithms,
                              rank_by=rank_by, resilience=resilience,
                              progress=progress, **enum_kw)
        cfgs = list(enumerate_configs(world, **enum_kw))
        # partition by structure key: every class compiles in exactly one
        # worker (and fork inherits the warmed assembly cache for free)
        _cache.builder(self.spec, self.mode)
        buckets: dict = {}
        for i, cfg in enumerate(cfgs):
            buckets.setdefault(CompiledBackend._structure_key(cfg),
                               []).append((i, cfg))
        chunks: list[list] = [[] for _ in range(workers)]
        for b in sorted(buckets.values(), key=len, reverse=True):
            min(chunks, key=len).extend(b)
        chunks = [c for c in chunks if c]
        prog_cb = _Progress(progress, len(cfgs))
        with ProcessPoolExecutor(max_workers=len(chunks),
                                 mp_context=ctx) as pool:
            from concurrent.futures import as_completed
            futs = [pool.submit(_sweep_chunk_worker, self, hw, c,
                                mem_limit_gb, recompute, algorithms)
                    for c in chunks]
            indexed = []
            # per-chunk progress granularity: each worker resolves its
            # whole share before reporting back
            for f in as_completed(futs):
                rows = f.result()
                indexed.extend(rows)
                prog_cb.tick(n=len(rows),
                             skipped=sum(1 for _, r in rows
                                         if not isinstance(r, DSEPoint)))
        indexed.sort(key=lambda r: r[0])         # enumeration order
        points = [r for _, r in indexed if isinstance(r, DSEPoint)]
        skipped = [r for _, r in indexed if not isinstance(r, DSEPoint)]
        if resilience is not None:
            score_resilience(points, resilience, hw)
        rank_points(points, rank_by)
        return SweepResult(points, skipped, backend=self.backend)


def _sweep_chunk_worker(sc: "Scenario", hw: HardwareProfile, items: list,
                        mem_limit_gb, recompute, algorithms=None) -> list:
    """Process-pool body: evaluate ``[(enum index, cfg), ...]`` serially
    with this worker's own compiled engine; returns indexed results."""
    from .core.dse import evaluate_or_skip

    env = sc.env()
    engine = (_engines.engine(sc.spec, sc.mode, env)
              if sc.backend in ("compiled", "batched") else None)
    src = _cache.builder(sc.spec, sc.mode)
    return [(idx, evaluate_or_skip(
                cfg, env=env, hw=hw, n_layers=total_layers(sc.spec),
                name=sc.spec.name, engine=engine,
                build=None if engine is not None else
                (lambda: src.clone().graph),
                recompute=recompute, mem_limit_gb=mem_limit_gb, reuse=True,
                algorithms=algorithms))
            for idx, cfg in items]


# --------------------------------------------------------------------------
# Trace
# --------------------------------------------------------------------------

class Trace:
    """Lazy, memoized handle over one scenario's generated pipeline.

    Nothing runs at construction; ``.graph`` triggers clone + distribute
    + pipeline-cut, ``.workload`` additionally instantiates, and each
    analysis (:meth:`simulate`, :meth:`memory`) is cached per argument
    set.  A Trace owns its graph clone — mutating it never affects the
    cache or other traces."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self._env: Optional[Env] = None
        self._graph: Optional[Graph] = None
        self._plan: Optional[PipelinePlan] = None
        self._dist_report: Optional[DistReport] = None
        self._workload: Optional[Workload] = None
        self._sim: dict = {}
        self._mem: dict = {}

    # ---- pipeline stages (lazy) ----------------------------------------
    @property
    def env(self) -> Env:
        if self._env is None:
            self._env = self.scenario.env()
        return self._env

    @property
    def graph(self) -> Graph:
        if self._graph is None:
            sc = self.scenario
            with _span("trace.distribute", spec=sc.spec.name, mode=sc.mode):
                graph = sc.builder().graph
                self._dist_report = distribute(graph, sc.cfg, self.env)
                self._plan = apply_pipeline(graph, sc.cfg.pp,
                                            total_layers(sc.spec),
                                            vstages=sc.cfg.vstages)
            self._graph = graph
        return self._graph

    @property
    def plan(self) -> PipelinePlan:
        _ = self.graph
        return self._plan

    @property
    def dist_report(self) -> DistReport:
        _ = self.graph
        return self._dist_report

    @property
    def workload(self) -> Workload:
        if self._workload is None:
            sc = self.scenario
            name = sc.name or f"{sc.spec.name}/{sc.mode}"
            with _span("trace.instantiate", spec=sc.spec.name,
                       backend=sc.backend):
                if sc.backend in ("compiled", "batched"):
                    # numeric replay via the shared engine: no per-trace
                    # sympy substitution, and the structure class is reused
                    # across traces/sweeps with the same (spec, mode, env)
                    eng = _engines.engine(sc.spec, sc.mode, self.env)
                    self._workload = eng.workload(sc.cfg, name=name)
                else:
                    self._workload = instantiate(self.graph, sc.cfg,
                                                 self.env, self.plan,
                                                 name=name)
        return self._workload

    # ---- analyses (memoized) -------------------------------------------
    @staticmethod
    def _hw_key(hw: HardwareProfile) -> tuple:
        # content-based: two profiles sharing a name (e.g. via
        # dataclasses.replace what-ifs) must not share a cache slot
        return (hw.name, hw.peak_flops, hw.hbm_bw, hw.link_bw,
                tuple(sorted(hw.link_bw_axis.items())), hw.link_latency,
                tuple(sorted(hw.efficiency.items())), hw.mem_capacity,
                hw.topology)

    def simulate(self, hw: HardwareProfile = TPU_V5E, *,
                 recompute: bool = False,
                 microbatches: Optional[int] = None,
                 schedule: Optional[str] = None,
                 vstages: Optional[int] = None,
                 algorithms: Optional[dict] = None,
                 perturb=None) -> SimResult:
        """Analytic step time; ``schedule``/``vstages``/``microbatches``
        override the config's pipeline schedule for what-if analysis
        without re-instantiating the workload.  The scenario's cluster
        topology (:meth:`Scenario.cluster`) and collective-algorithm
        overrides apply; ``algorithms`` adds per-call overrides on
        top.  ``perturb`` injects stragglers — a
        :class:`~repro_torch.ft.stragglers.StragglerModel` or a per-stage
        busy-multiplier sequence — replayed identically by both
        backends (see :func:`repro_torch.core.simulate.simulate`)."""
        hw = self.scenario._effective_hw(hw)
        algos = dict(self.scenario.algorithms)
        algos.update(algorithms or {})
        pk = tuple(perturb) if isinstance(perturb, (list, tuple)) \
            else perturb
        key = (self._hw_key(hw), recompute, microbatches, schedule, vstages,
               tuple(sorted(algos.items())), pk)
        if key not in self._sim:
            with _span("trace.simulate", hw=hw.name,
                       schedule=schedule or self.scenario.cfg.schedule):
                self._sim[key] = simulate(self.workload, hw,
                                          recompute=recompute,
                                          microbatches=microbatches,
                                          schedule=schedule, vstages=vstages,
                                          algorithms=algos or None,
                                          perturb=perturb)
        return self._sim[key]

    def memory(self, *, stage: int = 0, recompute: bool = False,
               master_fp32: bool = True,
               grad_dtype: str = "fp32") -> MemoryReport:
        key = (stage, recompute, master_fp32, grad_dtype)
        if key not in self._mem:
            sc = self.scenario
            if sc.backend in ("compiled", "batched"):
                eng = _engines.engine(sc.spec, sc.mode, self.env)
                self._mem[key] = eng.memory(
                    sc.cfg, stage=stage, recompute=recompute,
                    master_fp32=master_fp32, grad_dtype=grad_dtype)
            else:
                self._mem[key] = peak_memory(
                    self.graph, sc.cfg, self.env, self.plan,
                    stage=stage, recompute=recompute, master_fp32=master_fp32,
                    grad_dtype=grad_dtype)
        return self._mem[key]

    # ---- workload summaries (paper tables) -----------------------------
    def op_counts(self, stage: int = 0) -> dict:
        return self.workload.op_counts(stage)

    def comm_counts(self, stage: int = 0) -> dict:
        return self.workload.comm_counts(stage)

    def comm_volume(self, stage: int = 0) -> dict:
        return self.workload.comm_volume(stage)

    def flops_by_category(self, stage: int = 0) -> dict:
        return self.workload.flops_by_category(stage)

    def total_flops(self, stage: int = 0) -> float:
        return self.workload.total_flops(stage)

    # ---- export ---------------------------------------------------------
    def _comm_model(self, topology=None):
        """Topology-aware collective model for Chakra stamping (None
        when neither the export call nor the scenario supplies a cluster
        topology — exports then carry no fabric attrs, matching the
        historical output)."""
        sc = self.scenario
        topology = topology or sc.topology
        if topology is None:
            return None
        from .core.collectives import CollectiveModel
        return CollectiveModel(topology, cfg=sc.cfg,
                               algorithms=dict(sc.algorithms) or None)

    # ---- resilience ------------------------------------------------------
    def resilience_report(self, hw: HardwareProfile = TPU_V5E, *,
                          spec: Optional[ResilienceSpec] = None):
        """Expected goodput under failures for THIS config
        (:func:`repro_torch.ft.goodput.score_point`): failure model from the
        effective topology's MTBF annotations, checkpoint/restore costs
        from the memory model's persistent state, Young-Daly interval
        unless the spec pins one."""
        from .ft.goodput import score_point
        sc = self.scenario
        spec = spec or sc.resilience_spec
        if spec is None:
            raise ValueError("no resilience spec: pass spec=... or set one "
                             "with Scenario.resilience(...)")
        hw = sc._effective_hw(hw)
        return score_point(sc.cfg, self.simulate(hw), self.memory(),
                           spec, hw)

    def resilience_events(self, hw: HardwareProfile = TPU_V5E, *,
                          spec: Optional[ResilienceSpec] = None,
                          steps: int = 1000):
        """Sample this config's failure process over ``steps`` training
        steps of wall clock and replay it into (failure, restore)
        incidents — the timeline :meth:`export_chakra` stamps.  Returns
        ``(report, events)``; deterministic in the spec's seed."""
        from .ft.goodput import ReplayEvent, replay_goodput, score_point
        sc = self.scenario
        spec = spec or sc.resilience_spec
        if spec is None:
            raise ValueError("no resilience spec: pass spec=... or set one "
                             "with Scenario.resilience(...)")
        hw = sc._effective_hw(hw)
        sim = self.simulate(hw)
        rep = score_point(sc.cfg, sim, self.memory(), spec, hw)
        model = spec.failure_model(getattr(hw, "topology", None), sc.world)
        horizon = max(steps, 1) * sim.step_time
        trace = model.sample(horizon, seed=spec.seed)
        if math.isinf(rep.interval):
            # peer recovery: no rewind — each incident restores to the
            # current step; failures during downtime are absorbed
            dt = max(sim.step_time, 1e-12)
            events, t_up = [], 0.0
            for e in trace.events:
                if e.t < t_up:
                    continue
                t_up = e.t + rep.restore_cost
                events.append(ReplayEvent(e.t, t_up, int(e.t // dt),
                                          e.domain))
            events = tuple(events)
        else:
            events = replay_goodput(trace, rep.interval, rep.ckpt_cost,
                                    rep.restore_cost,
                                    horizon=horizon).events
        return rep, events

    def _resilience_export_args(self, resilience, hw, steps):
        """Normalize export_chakra's ``resilience=`` into (events, meta):
        a spec (or True = the scenario's) samples + replays; an iterable
        of events passes through unmeta'd."""
        if resilience is None:
            return None, None
        if resilience is True or isinstance(resilience, ResilienceSpec):
            spec = None if resilience is True else resilience
            rep, events = self.resilience_events(hw, spec=spec, steps=steps)
            meta = {"recovery": rep.recovery,
                    "goodput": round(rep.goodput, 6),
                    "interval_s": (None if math.isinf(rep.interval)
                                   else round(rep.interval, 3)),
                    "seed": (spec or self.scenario.resilience_spec).seed}
            return events, meta
        return list(resilience), None

    def export_chakra(self, out_dir: str,
                      ranks: Optional[Iterable[int]] = None, *,
                      decompose_alltoall: bool = False,
                      expand_microbatches: bool = False,
                      topology: Optional[ClusterTopology] = None,
                      resilience=None, resilience_steps: int = 1000,
                      hw: HardwareProfile = TPU_V5E,
                      on_stale: str = "error") -> int:
        """Write per-rank Chakra-schema JSON traces; returns file count.

        ``expand_microbatches`` unrolls the configured pipeline schedule
        into per-microbatch node instances (slot order preserved via
        control deps) so downstream feeders replay the schedule.  With a
        cluster topology (from ``topology=``, or the scenario's
        :meth:`Scenario.cluster`), comm nodes carry ``algorithm`` /
        ``tier`` / ``pg_stride`` attrs describing the fabric span their
        group crosses — pass ``topology=hw.topology`` to stamp with the
        same fabric a topology-carrying profile simulated on.
        ``on_stale`` governs leftover rank files from a previous export
        into the same directory (error | clean | ignore).

        ``resilience`` stamps a sampled failure/restore timeline into
        every rank body as annotated epoch markers (verified by the
        ``STG4xx`` trace checks): pass ``True`` to use the scenario's
        :meth:`Scenario.resilience` spec, a
        :class:`~repro_torch.ft.goodput.ResilienceSpec`, or a pre-replayed
        event sequence; ``resilience_steps``/``hw`` size the sampled
        horizon.  Omitted, the export is byte-identical to before."""
        events, meta = self._resilience_export_args(resilience, hw,
                                                    resilience_steps)
        with _span("trace.export_chakra", out_dir=out_dir,
                   expand=expand_microbatches):
            return export_ranks(self.workload, out_dir, ranks,
                                decompose_alltoall=decompose_alltoall,
                                expand_microbatches=expand_microbatches,
                                comm_model=self._comm_model(topology),
                                resilience_events=events,
                                resilience_meta=meta,
                                on_stale=on_stale)

    def chakra_stage(self, stage: int = 0, *,
                     decompose_alltoall: bool = False,
                     expand_microbatches: bool = False,
                     topology: Optional[ClusterTopology] = None,
                     resilience=None, resilience_steps: int = 1000,
                     hw: HardwareProfile = TPU_V5E) -> dict:
        events, _ = self._resilience_export_args(resilience, hw,
                                                 resilience_steps)
        return export_stage(self.workload, stage,
                            decompose_alltoall=decompose_alltoall,
                            expand_microbatches=expand_microbatches,
                            comm_model=self._comm_model(topology),
                            resilience_events=events)

    # ---- observability ---------------------------------------------------
    def timeline(self, path: Optional[str] = None,
                 hw: HardwareProfile = TPU_V5E, *,
                 recompute: bool = False,
                 microbatches: Optional[int] = None,
                 schedule: Optional[str] = None,
                 vstages: Optional[int] = None,
                 algorithms: Optional[dict] = None,
                 perturb=None,
                 resilience=None, resilience_steps: int = 1000,
                 memory: bool = False,
                 detail: str = "comm") -> "Timeline":
        """Perfetto/Chrome-trace timeline of the simulated execution:
        one track per pipeline stage with microbatch-expanded schedule
        slots, a comm stream of collective spans (algorithm/tier/bytes
        from the scenario's cluster model), and explicit bubble spans —
        every span from the same float arithmetic as :meth:`simulate`,
        so per-track span sums reconcile exactly with
        ``SimResult.step_time`` (:meth:`~repro_torch.obs.Timeline.reconcile`).

        ``path`` saves Chrome-trace JSON (open in ui.perfetto.dev);
        the returned :class:`~repro_torch.obs.Timeline` also derives a
        :class:`~repro_torch.obs.UtilizationReport` via ``.utilization()``.
        What-if overrides (``schedule``/``microbatches``/``perturb``/…)
        mirror :meth:`simulate`; ``resilience`` adds a failure/restore
        epoch track (same forms as :meth:`export_chakra`); ``memory``
        adds memory-over-time counters per stage; ``detail`` is
        ``"comm"`` (default), ``"all"`` (per-op compute spans), or
        ``"slots"``."""
        from .obs.timeline import build_timeline
        sc = self.scenario
        hw = sc._effective_hw(hw)
        algos = dict(sc.algorithms)
        algos.update(algorithms or {})
        events, _ = self._resilience_export_args(resilience, hw,
                                                 resilience_steps)
        mem = None
        if memory:
            mem = {s: self.memory(stage=s, recompute=recompute)
                   for s in range(max(1, sc.cfg.pp))}
        with _span("trace.timeline", hw=hw.name,
                   schedule=schedule or sc.cfg.schedule):
            tl = build_timeline(self.workload, hw, recompute=recompute,
                                microbatches=microbatches,
                                schedule=schedule, vstages=vstages,
                                algorithms=algos or None,
                                perturb=perturb,
                                resilience_events=events,
                                memory=mem, detail=detail,
                                label=sc.describe())
        if path:
            tl.save(path)
        return tl

    # ---- static verification --------------------------------------------
    def verify(self, *, include_graph: Optional[bool] = None,
               chakra: bool = False) -> "Report":
        """Static-analysis report over this trace's artifacts
        (:mod:`repro_torch.analysis`): comm checks + schedule checks over the
        instantiated workload, graph lint over the distributed symbolic
        graph, and (``chakra=True``) Chakra validation of every stage
        body as it would be exported.

        ``include_graph=None`` (default) lints the symbolic graph only
        when it is already materialized — forcing ``.graph`` on a
        compiled-backend trace would run the sympy distribute pass this
        backend exists to avoid; pass ``include_graph=True`` to force
        it.  The pass suite is pure traversal, far below export cost."""
        from .analysis import (check_comm, check_trace,
                               check_workload_schedule, lint_graph)
        from .analysis.diagnostics import Report
        w = self.workload
        rep = Report(name=self.scenario.describe())
        if include_graph or (include_graph is None
                             and self._graph is not None):
            rep.extend(lint_graph(self.graph, self.env))
        rep.extend(check_comm(w))
        rep.extend(check_workload_schedule(w))
        if chakra:
            for s in range(w.stages):
                rep.extend(check_trace(self.chakra_stage(s), rank=None,
                                       name=f"stage{s}"))
        return rep

    # ---- one-line report (launch pre-flight) ----------------------------
    def summary(self, hw: HardwareProfile = TPU_V5E, *,
                recompute: bool = False) -> dict:
        sim = self.simulate(hw, recompute=recompute)
        mem = self.memory(recompute=recompute)
        return {"scenario": self.scenario.describe(), "hw": hw.name,
                "world": self.scenario.world,
                "step_ms": round(sim.ms, 3),
                "overlap": round(sim.overlap_ratio, 3),
                "exposed_comm_ms": round(sim.exposed_comm * 1e3, 3),
                "peak_gb": round(mem.peak_gb, 2)}

    def __repr__(self) -> str:
        state = "materialized" if self._workload is not None else "lazy"
        return f"Trace({self.scenario.describe()}, {state})"


# --------------------------------------------------------------------------
# Phase programs: Phase / Job
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Phase:
    """One Scenario-like unit of a phase program: a workload shape +
    parallelization executed ``steps`` times on a named ``pool``.
    ``kv_growth=1`` advances the KV length by one entry per step (decode
    against a growing cache) — those phases are evaluated in closed form
    by :class:`~repro_torch.core.serving.DecodeSeries`, not step-by-step."""
    scenario: Scenario
    steps: int = 1
    kv_growth: int = 0
    pool: str = "default"
    name: str = ""

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.kv_growth not in (0, 1):
            raise ValueError("kv_growth must be 0 (static shape) or 1 "
                             "(one KV entry per decoded token)")
        if self.kv_growth and self.scenario.mode != "decode":
            raise ValueError("kv_growth requires a decode-mode scenario")
        if self.kv_growth and self.scenario.kv_len is None:
            raise ValueError("kv_growth phase needs the starting KV length "
                             "(Scenario.decode(batch=..., kv_len=...))")


def _as_cfg(pool, template: Scenario) -> ParallelCfg:
    """Coerce a pool description (ParallelCfg | Scenario | .parallel()
    kwargs dict) onto a phase's scenario."""
    if isinstance(pool, ParallelCfg):
        return pool
    if isinstance(pool, Scenario):
        return pool.cfg
    if isinstance(pool, dict):
        return template.parallel(**pool).cfg
    raise TypeError(f"pool must be ParallelCfg, Scenario or dict of "
                    f".parallel() kwargs, got {type(pool).__name__}")


@dataclass(frozen=True)
class Job:
    """A phase program: phases composed sequentially onto named pools.

    Build one with :meth:`Scenario.generation` (prefill + growing-KV
    decode), :meth:`Job.request`, or directly from :class:`Phase` units;
    :meth:`disaggregate` moves prefill and decode onto separate pools
    with an explicit KV-cache handoff.  :meth:`evaluate` returns
    end-to-end serving metrics (TTFT / TPOT / tokens/s / peak KV) with
    O(1) engine evaluations per decode phase regardless of step count;
    :meth:`sweep` makes ``out_tokens`` and the pool split DSE
    dimensions; :meth:`export_chakra` stamps the whole timeline as one
    coherent per-rank trace set."""
    phases: tuple = ()
    kv_transfer_bw: Optional[float] = None   # bytes/s; None -> hw.link_bw
    disaggregated: bool = False
    name: str = ""

    def __post_init__(self):
        if not self.phases:
            raise ValueError("a Job needs at least one Phase")

    # ---- construction ---------------------------------------------------
    @staticmethod
    def request(*, prefill, decode_steps: int, decode=None) -> "Job":
        """A single batched request: one prefill phase, then
        ``decode_steps`` growing-KV decode steps.  ``prefill`` is a
        prefill-mode :class:`Scenario` (or a :class:`Phase` wrapping
        one); ``decode`` defaults to the same model/parallelization
        decoding against the prompt-length cache."""
        pre = prefill if isinstance(prefill, Phase) \
            else Phase(prefill, steps=1, name="prefill")
        if pre.scenario.mode != "prefill":
            raise ValueError(f"prefill phase must be prefill-mode, got "
                             f"{pre.scenario.mode!r}")
        phases = [pre]
        if decode_steps:
            sc = decode if decode is not None else \
                pre.scenario.decode(batch=pre.scenario.batch,
                                    kv_len=pre.scenario.seq)
            if sc.mode != "decode":
                raise ValueError(f"decode phase must be decode-mode, got "
                                 f"{sc.mode!r}")
            phases.append(Phase(sc, steps=decode_steps, kv_growth=1,
                                name="decode"))
        return Job(phases=tuple(phases), name=pre.scenario.spec.name)

    def disaggregate(self, *, prefill_pool=None, decode_pool=None,
                     kv_transfer: Optional[float] = None) -> "Job":
        """Split prefill and decode onto separate pools (paper Table IX /
        DistServe-style serving): prefill-mode phases adopt
        ``prefill_pool``'s parallelization, decode-mode phases
        ``decode_pool``'s, and the KV cache produced by prefill is
        shipped between the pools at ``kv_transfer`` bytes/s (default:
        the profile's link bandwidth).  Pools are :class:`ParallelCfg`,
        a scenario, or a dict of :meth:`Scenario.parallel` kwargs."""
        out = []
        for ph in self.phases:
            pool = {"prefill": prefill_pool,
                    "decode": decode_pool}.get(ph.scenario.mode)
            if pool is None:
                out.append(ph)
                continue
            cfg = _as_cfg(pool, ph.scenario)
            out.append(replace(ph, scenario=ph.scenario.with_cfg(cfg),
                               pool=ph.scenario.mode))
        return replace(self, phases=tuple(out), disaggregated=True,
                       kv_transfer_bw=kv_transfer if kv_transfer is not None
                       else self.kv_transfer_bw)

    def with_kv_transfer(self, bw: float) -> "Job":
        """Set the prefill→decode KV handoff bandwidth (bytes/s) used by
        disaggregated evaluation and sweeps."""
        return replace(self, kv_transfer_bw=bw)

    def with_out_tokens(self, out_tokens: int) -> "Job":
        """The same program generating ``out_tokens`` tokens: resizes
        the growing-KV decode phase (requires exactly one);
        ``out_tokens=1`` drops it entirely (prefill-only — the prompt's
        first token is the whole generation)."""
        if out_tokens < 1:
            raise ValueError(f"out_tokens must be >= 1, got {out_tokens}")
        growth = [i for i, p in enumerate(self.phases) if p.kv_growth]
        if len(growth) != 1:
            raise ValueError(f"with_out_tokens needs exactly one growing "
                             f"decode phase, found {len(growth)}")
        phases = list(self.phases)
        if out_tokens == 1:
            if not any(p.scenario.mode == "prefill" for p in phases):
                raise ValueError("out_tokens=1 needs a prefill phase to "
                                 "produce the token")
            del phases[growth[0]]
        else:
            phases[growth[0]] = replace(phases[growth[0]],
                                        steps=out_tokens - 1)
        return replace(self, phases=tuple(phases))

    # ---- derived --------------------------------------------------------
    @property
    def out_tokens(self) -> int:
        """Tokens produced per sequence: one from prefill + one per
        growing decode step."""
        dec = sum(p.steps for p in self.phases
                  if p.kv_growth and p.scenario.mode == "decode")
        pre = 1 if any(p.scenario.mode == "prefill"
                       for p in self.phases) else 0
        return pre + dec

    @property
    def batch(self) -> int:
        return self.phases[0].scenario.batch

    def describe(self) -> str:
        bits = []
        for p in self.phases:
            sc = p.scenario
            tag = p.name or sc.mode
            bits.append(f"{tag}×{p.steps}@{p.pool}[{sc.cfg.describe()}]")
        return (self.name or self.phases[0].scenario.spec.name) \
            + ": " + " → ".join(bits)

    # ---- evaluation -----------------------------------------------------
    def evaluate(self, hw: HardwareProfile = TPU_V5E) -> JobResult:
        """End-to-end serving metrics for the whole timeline.

        Static phases cost one trace simulation; growing-KV decode
        phases cost O(1) engine evaluations via the closed-form
        :class:`~repro_torch.core.serving.DecodeSeries` (exact on linear
        stretches of the per-step time, pinned-error subdivision at
        breakpoints).  For disaggregated jobs the prefill→decode KV
        handoff is charged at :attr:`kv_transfer_bw`."""
        with _span("job.evaluate", phases=len(self.phases),
                   disaggregated=self.disaggregated):
            return self._evaluate(hw)

    def _evaluate(self, hw: HardwareProfile) -> JobResult:
        phases_out: list[PhaseResult] = []
        evals = {"lowerings": 0, "samples": 0, "trace_sims": 0}
        ttft = None
        decode_total = 0.0
        decode_steps = 0
        elapsed = 0.0
        first_series: Optional[DecodeSeries] = None
        for ph in self.phases:
            sc = ph.scenario
            hw_eff = sc._effective_hw(hw)
            algos = dict(sc.algorithms) or None
            if ph.kv_growth:
                series = _series_for(sc, ph.steps)
                if first_series is None:
                    first_series = series
                # the range endpoints are reported on the PhaseResult
                # anyway, so simulate them once and seed the closed-form
                # sum with their step times instead of evaluating twice
                sim0 = series.step_sim(0, hw_eff, algorithms=algos)
                sim_n = series.step_sim(ph.steps - 1, hw_eff,
                                        algorithms=algos)
                t_total, n = series.total_time(
                    hw_eff, steps=ph.steps, algorithms=algos,
                    seed={0: sim0.step_time,
                          ph.steps - 1: sim_n.step_time})
                mem = series.step_memory(ph.steps - 1, exact=False)
                kv_loc = series.kv_bytes(ph.steps - 1, local=True)
                kv_end = series.kv_bytes(ph.steps - 1)
                evals["lowerings"] += series.engine_calls
                evals["samples"] += n + 2
                pr = PhaseResult(
                    name=ph.name or sc.mode, pool=ph.pool, mode=sc.mode,
                    steps=ph.steps, time=t_total,
                    step_first=sim0.step_time, step_last=sim_n.step_time,
                    evals=n, peak_gb=mem.peak_gb + kv_loc / 2**30,
                    kv_bytes_end=kv_end, world=sc.world, sim=sim_n)
                decode_total += t_total
                decode_steps += ph.steps
            else:
                tr = sc.trace()
                sim = tr.simulate(hw)
                mem = tr.memory()
                t_total = sim.step_time * ph.steps
                evals["trace_sims"] += 1
                pr = PhaseResult(
                    name=ph.name or sc.mode, pool=ph.pool, mode=sc.mode,
                    steps=ph.steps, time=t_total,
                    step_first=sim.step_time, step_last=sim.step_time,
                    evals=1, peak_gb=mem.peak_gb, world=sc.world, sim=sim)
            phases_out.append(pr)
            elapsed += pr.time
            if ttft is None and sc.mode == "prefill":
                ttft = elapsed
        kv_bytes = kv_time = 0.0
        if self.disaggregated and first_series is not None:
            kv_bytes = first_series.kv_bytes(0)
            bw = self.kv_transfer_bw if self.kv_transfer_bw is not None \
                else hw.link_bw
            kv_time = kv_bytes / bw if bw else 0.0
            # the handoff happens once, between prefill and decode
            for pr in phases_out:
                if pr.mode == "prefill":
                    pr.kv_bytes_end = kv_bytes
        elif first_series is not None:
            for pr in phases_out:
                if pr.mode == "prefill":
                    pr.kv_bytes_end = first_series.kv_bytes(0)
        return JobResult(
            phases=phases_out, batch=self.batch,
            out_tokens=self.out_tokens,
            ttft=ttft if ttft is not None else 0.0,
            tpot=(decode_total / decode_steps) if decode_steps else 0.0,
            total_time=elapsed + kv_time,
            kv_transfer_bytes=kv_bytes, kv_transfer_time=kv_time,
            disaggregated=self.disaggregated, engine_evals=evals,
            label=self.describe())

    def timeline(self, path: Optional[str] = None,
                 hw: HardwareProfile = TPU_V5E) -> "Timeline":
        """Pool-lane Perfetto timeline of this job's evaluated phase
        program: one lane per pool (prefill / decode / both on one for
        colocated jobs), phase spans annotated with mode / steps /
        per-step times / peak memory, and — for disaggregated jobs — an
        explicit kv-transfer lane for the prefill→decode handoff.
        ``path`` saves Chrome-trace JSON (open in ui.perfetto.dev)."""
        from .obs.timeline import job_timeline
        tl = job_timeline(self.evaluate(hw))
        if path:
            tl.save(path)
        return tl

    # ---- DSE ------------------------------------------------------------
    def sweep(self, world: int, hw: HardwareProfile = TPU_V5E, *,
              out_tokens=None, splits=None,
              mem_limit_gb: Optional[float] = None,
              rank_by: str = "step_time",
              resilience: Optional[ResilienceSpec] = None,
              search: str = "full",
              device=None,
              **enum_kw) -> list:
        """Serving DSE: rank parallelizations (and, with ``splits``,
        prefill/decode pool partitions) by generated tokens/s.

        ``out_tokens`` makes the generation length a swept dimension;
        ``splits`` is an iterable of ``(prefill_world, decode_world)``
        pool partitions (or ``"auto"`` for the power-of-two splits of
        ``world``) — each split is optimized per pool *independently*
        (the metrics decompose: TTFT depends only on the prefill cfg,
        the decode total only on the decode cfg, and the KV handoff
        bytes are sharding-invariant).  Returns
        :class:`~repro_torch.core.dse.ServingPoint` rows sorted by tokens/s;
        see :func:`repro_torch.core.dse.enumerate_pool_splits`.

        ``resilience`` scores each point's availability under failures
        (serving keeps no mutable state, so goodput is
        ``1/(1 + rate*restore)`` — see
        :func:`repro_torch.ft.goodput.score_serving_point`);
        ``rank_by="effective_goodput"`` orders by availability-deflated
        tokens/s.

        ``search`` ("full" | "pareto" | "bnb") tunes the per-pool-split
        prefill sweep: branch-and-bound prunes the prefill config
        lattice instead of enumerating it, which matters when ``splits``
        multiplies the number of inner sweeps.  The prefill phase's
        scenario backend (``.with_backend("batched")``) applies there
        too, on ``device`` (as :meth:`Scenario.sweep`)."""
        from .core.dse import RANK_MODES, ServingPoint, \
            enumerate_configs, enumerate_pool_splits
        if rank_by not in RANK_MODES:
            raise ValueError(f"rank_by {rank_by!r} not in {RANK_MODES}")
        if resilience is None:
            resilience = next((p.scenario.resilience_spec
                               for p in self.phases
                               if p.scenario.resilience_spec), None)
        if rank_by == "effective_goodput" and resilience is None:
            raise ValueError(
                'rank_by="effective_goodput" needs a resilience spec '
                "(pass resilience=... or set Scenario.resilience(...))")
        # descending: the largest length builds each cfg's series once;
        # every smaller length replays a prefix of it (total_time clips)
        toks = tuple(sorted(set(out_tokens), reverse=True)) \
            if out_tokens else (self.out_tokens,)
        if any(n != self.out_tokens for n in toks) \
                and not any(p.kv_growth for p in self.phases):
            raise ValueError(
                "sweeping out_tokens needs a growing decode phase in the "
                "job (this is a static program — build one with "
                "Scenario.generation(out_tokens=...) or Job.request)")
        points: list[ServingPoint] = []
        if splits is None:
            for cfg in enumerate_configs(world, **enum_kw):
                for n in toks:
                    try:
                        base = self if n == self.out_tokens \
                            else self.with_out_tokens(n)
                        res = base._on_cfg(cfg).evaluate(hw)
                    except InfeasibleConfigError:
                        continue
                    if mem_limit_gb is not None \
                            and res.peak_gb > mem_limit_gb:
                        continue
                    points.append(ServingPoint(
                        out_tokens=n, split=(world,), prefill_cfg=cfg,
                        decode_cfg=cfg, result=res))
        else:
            if splits == "auto":
                splits = enumerate_pool_splits(world)
            for wp, wd in splits:
                if wp + wd != world:
                    raise ValueError(f"split ({wp}, {wd}) does not "
                                     f"partition world={world}")
                for n in toks:
                    pt = self._best_split_point(wp, wd, n, hw,
                                                mem_limit_gb, enum_kw,
                                                search=search, device=device)
                    if pt is not None:
                        points.append(pt)
        if resilience is not None:
            self._score_serving(points, resilience, hw, world)
        if rank_by == "effective_goodput":
            points.sort(key=lambda p: -p.effective_tokens_per_s)
        else:
            points.sort(key=lambda p: -p.result.tokens_per_s)
        return points

    def _score_serving(self, points, resilience, hw, world: int) -> None:
        """Attach availability-under-failures reports to serving points:
        the decode pool's config (the steady-state pool) supplies the
        sharding, the whole job's ``world`` the failure exposure."""
        from .ft.goodput import score_serving_point
        steady = next((p.scenario for p in self.phases if p.kv_growth),
                      self.phases[-1].scenario)
        hw = steady._effective_hw(hw)
        mems: dict = {}
        for pt in points:
            cfg = pt.decode_cfg
            ck = cfg.describe()
            if ck not in mems:
                mems[ck] = steady.with_cfg(cfg).trace().memory()
            pt.resilience = score_serving_point(cfg, mems[ck], resilience,
                                                hw, world=world)

    def _on_cfg(self, cfg: ParallelCfg) -> "Job":
        """Every phase on ONE pool with ``cfg`` — a genuinely colocated
        job (pool names and the disaggregated flag reset, so no phantom
        KV handoff is charged to colocated sweep points)."""
        return replace(self, disaggregated=False, phases=tuple(
            replace(p, scenario=p.scenario.with_cfg(cfg), pool="default")
            for p in self.phases))

    def _best_split_point(self, wp: int, wd: int, n: int,
                          hw: HardwareProfile, mem_limit_gb, enum_kw,
                          search: str = "full", device=None):
        """Optimize one (prefill_world, decode_world) partition.

        The metrics decompose — TTFT depends only on the prefill cfg,
        the decode total only on the decode cfg, and the handoff bytes
        are sharding-invariant — so each pool is optimized on its OWN
        cost only (prefill: step time via :meth:`Scenario.sweep`;
        decode: closed-form series total), and the full job is
        evaluated exactly once at the end."""
        from .core.dse import ServingPoint, enumerate_configs
        base = self if n == self.out_tokens else self.with_out_tokens(n)
        pre_sc = next((p.scenario for p in base.phases
                       if p.scenario.mode == "prefill"), None)
        dec_ph = next((p for p in base.phases if p.kv_growth), None)
        if pre_sc is None or dec_ph is None:
            return None
        best_pre = None
        for pt in pre_sc.sweep(wp, hw, mem_limit_gb=mem_limit_gb,
                               search=search, device=device, **enum_kw):
            if "OOM" not in pt.label:
                best_pre = pt.cfg
                break
        if best_pre is None:
            return None
        best_dec, best_dec_t = None, None
        for cfg in enumerate_configs(wd, **enum_kw):
            dec_sc = dec_ph.scenario.with_cfg(cfg)
            try:
                series = _series_for(dec_sc, dec_ph.steps)
                # same effective fabric as the final evaluate (the
                # scenario's attached topology overlays the profile)
                t_dec, _ = series.total_time(
                    dec_sc._effective_hw(hw), steps=dec_ph.steps,
                    algorithms=dict(dec_sc.algorithms) or None)
            except InfeasibleConfigError:
                continue
            if mem_limit_gb is not None:
                peak = series.step_memory(
                    dec_ph.steps - 1, exact=False).peak_gb \
                    + series.kv_bytes(dec_ph.steps - 1,
                                      local=True) / 2**30
                if peak > mem_limit_gb:
                    continue
            if best_dec_t is None or t_dec < best_dec_t:
                best_dec, best_dec_t = cfg, t_dec
        if best_dec is None:
            return None
        res = base.disaggregate(prefill_pool=best_pre,
                                decode_pool=best_dec,
                                kv_transfer=self.kv_transfer_bw
                                ).evaluate(hw)
        if mem_limit_gb is not None and res.peak_gb > mem_limit_gb:
            return None
        return ServingPoint(out_tokens=n, split=(wp, wd),
                            prefill_cfg=best_pre, decode_cfg=best_dec,
                            result=res)

    # ---- export ---------------------------------------------------------
    def export_chakra(self, out_dir: str,
                      ranks: Optional[Iterable[int]] = None, *,
                      on_stale: str = "error") -> int:
        """Write the whole multi-phase timeline as per-rank Chakra JSON:
        phase bodies chained by phase-boundary control deps, decode
        phases stamped with their KV span (``kv_start``/``kv_end``/
        ``steps``), and — for disaggregated jobs — kv-transfer
        Send/Recv comm nodes between the pools (see
        :func:`repro_torch.core.chakra.export_job`).  ``on_stale`` governs
        leftover rank files from a previous export (error | clean |
        ignore)."""
        from .core.chakra import export_job
        items = []
        kv_bytes = 0.0
        for ph in self.phases:
            sc = ph.scenario
            if ph.kv_growth:
                series = _series_for(sc, ph.steps)
                w = series.step_workload(0, name=f"{sc.spec.name}/decode")
                w.meta = {"phase": ph.name or sc.mode, "pool": ph.pool,
                          "steps": ph.steps, "kv_start": sc.kv_len,
                          "kv_end": sc.kv_len + ph.steps - 1}
                if not kv_bytes:
                    kv_bytes = series.kv_bytes(0)
            else:
                w = sc.trace().workload
                w.meta = {"phase": ph.name or sc.mode, "pool": ph.pool,
                          "steps": ph.steps}
            items.append(w)
        return export_job(items, out_dir, ranks=ranks,
                          kv_transfer_bytes=kv_bytes
                          if self.disaggregated else 0.0,
                          on_stale=on_stale)

    # ---- static verification --------------------------------------------
    def verify(self, *, deep: bool = True) -> "Report":
        """Static-analysis report over the whole phase program
        (:mod:`repro_torch.analysis`): every phase's workload passes the comm
        + schedule checks, and with ``deep=True`` (default) the job is
        additionally exported to a temporary directory and its per-rank
        Chakra traces validated — including kv-transfer send/recv
        matching across disaggregated pools and SPMD rank agreement."""
        import tempfile

        from .analysis import check_trace_dir, verify_workload
        from .analysis.diagnostics import Report
        rep = Report(name=self.describe())
        for ph in self.phases:
            sc = ph.scenario
            if ph.kv_growth:
                series = _series_for(sc, ph.steps)
                w = series.step_workload(
                    0, name=f"{sc.spec.name}/{ph.name or sc.mode}")
                rep.extend(verify_workload(w))
            else:
                rep.extend(sc.trace().verify())
        if deep:
            with tempfile.TemporaryDirectory() as d:
                self.export_chakra(d)
                rep.extend(check_trace_dir(d, name="export"))
        return rep


def _series_for(sc: Scenario, steps: int) -> DecodeSeries:
    """The process-wide cached closed-form series for one decode phase."""
    return _series.series(sc, steps)
