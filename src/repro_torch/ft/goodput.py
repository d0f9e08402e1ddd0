"""Checkpoint costing, Young-Daly intervals, and goodput under failures.

The delivered throughput of a large training job is not its step time:
it is step time deflated by checkpoint writes, lost work, and restore
downtime.  Following RAPID-LLM's resilience-aware analysis, this module
closes the loop between STAGE's performance model and its failure model
(:mod:`repro_torch.ft.failures`):

* **Checkpoint cost** — derived from the memory model's persistent
  state (params + optimizer + master copies, already sharded the way
  the parallel config shards them) streamed to a :class:`CkptTier`
  (local SSD / parallel FS / object store bandwidths per rank).

* **Closed-form goodput** — the exact renewal expression for periodic
  checkpointing under Poisson failures at aggregate rate ``lam``: an
  attempt of length ``tau = I + C`` succeeds with ``exp(-lam*tau)``, a
  failed attempt costs the time to the failure plus restore ``R``, so

      ``E[T per committed segment] = (1/lam + R) * (exp(lam*tau) - 1)``
      ``G = I / E[T]``

  (first-order expansion recovers Daly's classic approximation).  The
  Young-Daly interval ``I* = sqrt(2*C/lam)`` is exposed in closed form
  and cross-checked against seeded trace Monte Carlo by the tests.

* **Peer recovery** — configs with a replicated data-parallel group
  (``dp > 1``, no FSDP/ZeRO) can restore current-step state from a dp
  peer: no rewind, no steady-state checkpoint writes, so
  ``G = 1 / (1 + lam * R_peer)`` with ``R_peer`` = restart latency +
  one SendRecv of the state shard (costed by the real
  :class:`~repro_torch.core.collectives.CollectiveModel`).  This asymmetry is
  what makes ``rank_by="effective_goodput"`` flip step-time winners.

Pure python (no torch): importable from sweep workers in
:mod:`repro_torch.core.dse`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

from .failures import FailureModel, FailureTrace

__all__ = [
    "CkptTier", "CKPT_TIERS", "LOCAL_SSD", "PARALLEL_FS", "OBJECT_STORE",
    "state_bytes", "checkpoint_cost", "restore_cost", "young_daly_interval",
    "expected_goodput", "peer_goodput", "ReplayEvent", "ReplayResult",
    "replay_goodput", "overhead_curve", "ResilienceSpec", "ResilienceReport",
    "score_point", "score_serving_point",
]


# --------------------------------------------------------------------------
# Checkpoint bandwidth tiers
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CkptTier:
    """One checkpoint storage tier.

    Bandwidths are effective bytes/s *per writing rank* (every rank
    streams its own shard concurrently); ``restart_latency`` is the
    fixed per-incident cost of detecting the failure, rescheduling, and
    re-spawning the job before any state moves.
    """
    name: str
    write_bw: float
    read_bw: float
    restart_latency: float

    def __post_init__(self):
        if self.write_bw <= 0 or self.read_bw <= 0:
            raise ValueError(f"ckpt tier {self.name!r}: bandwidths must be > 0")
        if self.restart_latency < 0:
            raise ValueError(
                f"ckpt tier {self.name!r}: restart_latency must be >= 0")


LOCAL_SSD = CkptTier("local_ssd", write_bw=2e9, read_bw=3e9,
                     restart_latency=30.0)
PARALLEL_FS = CkptTier("parallel_fs", write_bw=0.8e9, read_bw=1.2e9,
                       restart_latency=60.0)
OBJECT_STORE = CkptTier("object_store", write_bw=0.25e9, read_bw=0.5e9,
                        restart_latency=120.0)

CKPT_TIERS = {t.name: t for t in (LOCAL_SSD, PARALLEL_FS, OBJECT_STORE)}


def _resolve_tier(ckpt: Union[str, CkptTier]) -> CkptTier:
    if isinstance(ckpt, CkptTier):
        return ckpt
    try:
        return CKPT_TIERS[ckpt]
    except KeyError:
        raise ValueError(f"unknown ckpt tier {ckpt!r} "
                         f"(bundled: {sorted(CKPT_TIERS)})") from None


# --------------------------------------------------------------------------
# Costs and closed forms
# --------------------------------------------------------------------------

def state_bytes(mem) -> float:
    """Bytes ONE rank must persist to make its shard recoverable: the
    memory report's weights + optimizer moments + fp32 master params.
    Gradients and activations are not checkpoint state; serving-mode
    reports have no optimizer terms so this degrades to weights-only."""
    return float(mem.weights + mem.opt_states + mem.master_params)


def checkpoint_cost(nbytes: float, ckpt: Union[str, CkptTier]) -> float:
    """Seconds to write one checkpoint (per-rank shard, parallel writes)."""
    return nbytes / _resolve_tier(ckpt).write_bw


def restore_cost(nbytes: float, ckpt: Union[str, CkptTier]) -> float:
    """Seconds from failure to resumed compute via storage: restart
    latency + reading the shard back."""
    tier = _resolve_tier(ckpt)
    return tier.restart_latency + nbytes / tier.read_bw


def young_daly_interval(ckpt_cost_s: float, system_mtbf: float) -> float:
    """Young-Daly optimal checkpoint interval ``sqrt(2 * C * MTBF)``."""
    if ckpt_cost_s < 0:
        raise ValueError("ckpt_cost_s must be >= 0")
    if system_mtbf <= 0:
        raise ValueError("system_mtbf must be > 0")
    if math.isinf(system_mtbf):
        return math.inf
    return math.sqrt(2.0 * ckpt_cost_s * system_mtbf)


def expected_goodput(interval: float, *, rate: float, ckpt_cost_s: float,
                     restore_cost_s: float) -> float:
    """Exact expected goodput of periodic checkpointing (see module
    docstring).  ``rate`` is the aggregate failure rate (1/system
    MTBF); ``rate == 0`` degrades to the pure write-overhead ratio."""
    if interval <= 0:
        raise ValueError("interval must be > 0")
    tau = interval + ckpt_cost_s
    if rate <= 0:
        return interval / tau
    return interval / ((1.0 / rate + restore_cost_s) * math.expm1(rate * tau))


def peer_goodput(rate: float, restore_cost_s: float) -> float:
    """Goodput under peer (dp-replica) recovery: no rewind, no
    checkpoint writes — each failure costs only the restore downtime."""
    return 1.0 / (1.0 + rate * restore_cost_s)


# --------------------------------------------------------------------------
# Trace Monte Carlo (cross-check of the closed form)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ReplayEvent:
    """One failure incident in a replayed trace."""
    t_fail: float
    t_restore: float
    ckpt_step: int      # committed segments at failure time (monotone)
    domain: str = ""


@dataclass(frozen=True)
class ReplayResult:
    goodput: float
    useful: float
    wall: float
    segments: int
    events: tuple[ReplayEvent, ...]


def replay_goodput(trace: FailureTrace, interval: float, ckpt_cost_s: float,
                   restore_cost_s: float, *,
                   horizon: Optional[float] = None) -> ReplayResult:
    """Replay periodic checkpointing against one sampled failure trace.

    Each attempt runs ``interval`` useful seconds then writes a
    checkpoint (``tau = interval + ckpt_cost_s``).  A failure inside the
    attempt discards it and costs ``(t_fail - t_start) + restore``;
    failures during downtime are absorbed (the closed form assumes
    failure-free restores — matching it is the point of this replay).
    Replaying MANY candidate intervals against ONE shared trace gives
    common random numbers, so the sampled overhead curve's argmin is a
    low-variance estimate of the true optimum.
    """
    if interval <= 0:
        raise ValueError("interval must be > 0")
    end = trace.horizon if horizon is None else horizon
    times = [e.t for e in trace.events]
    domains = [e.domain for e in trace.events]
    tau = interval + ckpt_cost_s
    t, useful, segments, i = 0.0, 0.0, 0, 0
    events: list[ReplayEvent] = []
    while t < end:
        while i < len(times) and times[i] < t:     # absorbed in downtime
            i += 1
        if i < len(times) and times[i] < t + tau:
            tf = times[i]
            t = tf + restore_cost_s
            events.append(ReplayEvent(tf, t, segments, domains[i]))
            i += 1
        else:
            t += tau
            useful += interval
            segments += 1
    goodput = useful / t if t > 0 else 0.0
    return ReplayResult(goodput, useful, t, segments, tuple(events))


def overhead_curve(trace: FailureTrace, intervals, ckpt_cost_s: float,
                   restore_cost_s: float) -> list[tuple[float, float]]:
    """``(interval, overhead)`` pairs from replaying each candidate
    against the SAME trace, with ``overhead = 1/goodput - 1`` (wasted
    seconds per useful second).  Its argmin is the empirically optimal
    interval the Young-Daly closed form should land on."""
    out = []
    for iv in intervals:
        rep = replay_goodput(trace, iv, ckpt_cost_s, restore_cost_s)
        ov = math.inf if rep.goodput <= 0 else 1.0 / rep.goodput - 1.0
        out.append((float(iv), ov))
    return out


# --------------------------------------------------------------------------
# Spec + per-config scoring (the DSE hook)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ResilienceSpec:
    """Sweep-wide resilience assumptions (hashable; rides on Scenario).

    ``mtbf`` — a float (per-CHIP MTBF in seconds) or a dict mapping
    failure-domain names to per-unit MTBFs: ``"chip"`` plus any tier
    name of the cluster topology (``"nvlink"``/``"ib"`` for the HGX
    pod).  Normalized to a sorted tuple so the spec stays hashable.
    ``ckpt`` — a bundled tier name or a :class:`CkptTier`.
    ``interval`` — checkpoint interval in seconds; ``None`` = Young-Daly
    optimal per config.  ``recovery`` — ``"storage"``, ``"peer"``, or
    ``"auto"`` (peer exactly when the config keeps a full replica: dp
    degree > 1 without FSDP/ZeRO-1 sharding).
    """
    mtbf: Union[float, dict, tuple]
    ckpt: Union[str, CkptTier] = "parallel_fs"
    interval: Optional[float] = None
    recovery: str = "auto"
    seed: int = 0

    def __post_init__(self):
        m = self.mtbf
        if isinstance(m, (int, float)):
            items = (("chip", float(m)),)
        elif isinstance(m, dict):
            items = tuple(sorted((str(k), float(v)) for k, v in m.items()))
        else:
            items = tuple((str(k), float(v)) for k, v in m)
        if not items:
            raise ValueError("ResilienceSpec.mtbf must name >= 1 domain")
        for name, val in items:
            if val <= 0:
                raise ValueError(f"mtbf[{name!r}] must be > 0 seconds")
        object.__setattr__(self, "mtbf", items)
        object.__setattr__(self, "ckpt", _resolve_tier(self.ckpt))
        if self.recovery not in ("auto", "storage", "peer"):
            raise ValueError(
                f"recovery must be auto|storage|peer, got {self.recovery!r}")
        if self.interval is not None and self.interval <= 0:
            raise ValueError("interval must be > 0 seconds (or None)")

    @property
    def mtbf_map(self) -> dict:
        return dict(self.mtbf)

    def failure_model(self, topology, world: int) -> FailureModel:
        mm = self.mtbf_map
        return FailureModel.from_topology(
            topology, world, chip_mtbf=mm.pop("chip", None), overrides=mm)

    def describe(self) -> str:
        mm = ", ".join(f"{k}={v:.0f}s" for k, v in self.mtbf)
        iv = "YD" if self.interval is None else f"{self.interval:.0f}s"
        return (f"mtbf({mm}) ckpt={self.ckpt.name} interval={iv} "
                f"recovery={self.recovery}")


@dataclass(frozen=True)
class ResilienceReport:
    """Per-config resilience outcome (attached to DSE points)."""
    world: int
    rate: float                 # aggregate failures/second
    system_mtbf: float
    state_bytes: float          # per-rank persistent shard
    ckpt_cost: float            # seconds per checkpoint write
    restore_cost: float         # seconds per incident
    interval: float             # inf in peer mode (no periodic writes)
    recovery: str               # "storage" | "peer"
    goodput: float              # fraction of wall clock that is useful

    def row(self) -> dict:
        return {"recovery": self.recovery, "goodput": round(self.goodput, 4),
                "mtbf_sys": round(self.system_mtbf, 1),
                "ckpt_s": round(self.ckpt_cost, 2),
                "restore_s": round(self.restore_cost, 2),
                "interval_s": (None if math.isinf(self.interval)
                               else round(self.interval, 1))}


def _resolve_recovery(spec: ResilienceSpec, cfg) -> str:
    if spec.recovery != "auto":
        return spec.recovery
    dp = cfg.degree(cfg.dp_axis) if cfg.dp_axis else 1
    replicated = dp > 1 and not cfg.fsdp and not cfg.zero1
    return "peer" if replicated else "storage"


def peer_restore_cost(sb: float, tier: CkptTier, cfg, hw) -> float:
    """Restore from a dp replica: restart latency + one point-to-point
    transfer of the state shard across the dp axis, costed on the real
    fabric (placement-aware when ``hw`` carries a topology)."""
    from ..core.collectives import comm_model
    cm = comm_model(hw, cfg)
    t = cm.time_of({"coll": "SendRecv", "axis": cfg.dp_axis, "group": 2,
                    "size": sb, "wire": sb})
    return tier.restart_latency + t


def score_point(cfg, sim, mem, spec: ResilienceSpec, hw) -> ResilienceReport:
    """Resilience-score one evaluated config: build its failure model,
    cost its checkpoints from the memory report, pick the recovery path,
    and return expected goodput.  Purely additive — callers divide
    ``sim.step_time`` by ``goodput`` for the effective step time."""
    world = cfg.world
    model = spec.failure_model(getattr(hw, "topology", None), world)
    lam = model.rate
    sb = state_bytes(mem)
    tier = spec.ckpt
    c = sb / tier.write_bw
    recovery = _resolve_recovery(spec, cfg)
    if recovery == "peer":
        r = peer_restore_cost(sb, tier, cfg, hw)
        g = peer_goodput(lam, r)
        interval = math.inf
    else:
        r = restore_cost(sb, tier)
        interval = spec.interval
        if interval is None:
            interval = young_daly_interval(c, model.system_mtbf)
        if math.isinf(interval):
            g = 1.0                      # no failures, no writes needed
        else:
            g = expected_goodput(interval, rate=lam, ckpt_cost_s=c,
                                 restore_cost_s=r)
    return ResilienceReport(world=world, rate=lam,
                            system_mtbf=model.system_mtbf, state_bytes=sb,
                            ckpt_cost=c, restore_cost=r, interval=interval,
                            recovery=recovery, goodput=g)


def score_serving_point(cfg, mem, spec: ResilienceSpec, hw, *,
                        world: Optional[int] = None) -> ResilienceReport:
    """Resilience-score one serving config.

    Serving jobs keep no mutable training state: weights are immutable,
    so a failure loses only the in-flight batch and recovery never
    rewinds.  Goodput is therefore pure availability
    ``1 / (1 + rate * restore)`` — with ``restore`` either reloading the
    weight shard from the checkpoint tier or streaming it from a dp
    replica (peer mode).  ``world`` overrides the failure-exposed rank
    count for disaggregated jobs whose pools jointly span more ranks
    than one pool's config."""
    world = cfg.world if world is None else world
    model = spec.failure_model(getattr(hw, "topology", None), world)
    lam = model.rate
    sb = state_bytes(mem)
    tier = spec.ckpt
    recovery = _resolve_recovery(spec, cfg)
    if recovery == "peer":
        r = peer_restore_cost(sb, tier, cfg, hw)
    else:
        r = restore_cost(sb, tier)
    return ResilienceReport(world=world, rate=lam,
                            system_mtbf=model.system_mtbf, state_bytes=sb,
                            ckpt_cost=sb / tier.write_bw, restore_cost=r,
                            interval=math.inf, recovery=recovery,
                            goodput=peer_goodput(lam, r))
