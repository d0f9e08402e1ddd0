"""Straggler injection + detection + elastic-rescale policy.

On a synchronous TPU pod a straggler stalls every step (collectives are
barriers), so mitigation is *detect -> evict -> re-scale*, not work
stealing.  Two halves live here:

* :class:`StragglerModel` — the *injection* side: a seeded slow-node
  distribution assigning each rank a busy-time multiplier.  Passed as
  ``perturb=`` to :func:`repro_torch.core.simulate.simulate` it scales every
  pipeline stage's compute by the slowest rank the stage hosts (the
  barrier semantics above), identically in the sympy and compiled
  backends — parity holds by construction because both route through
  the same replay.  Its per-host view also drives the watchdog, making
  the detection policy itself testable against a known ground truth.

* :class:`StragglerWatchdog` — the *detection* side: an EMA of step
  time; a step slower than ``threshold x`` EMA increments a strike
  counter per suspected host (in a real deployment the per-host timing
  comes from the coordinator service; here it is injected).  Strikes
  decay on healthy steps (``strike_decay``) so transient blips hours
  apart do not accumulate like a persistent straggler.  On
  ``max_strikes`` the policy emits an evict decision carrying the new
  world size — and the watchdog's own state shrinks with it (``n_hosts``
  decremented, the evicted host's strikes dropped), so consecutive
  evictions report consistent world sizes.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Decision", "StragglerWatchdog", "StragglerModel",
           "drive_watchdog", "elastic_mesh_shape"]


@dataclass
class Decision:
    kind: str                   # "ok" | "warn" | "evict"
    hosts: tuple = ()
    new_world: Optional[int] = None


@dataclass
class StragglerWatchdog:
    n_hosts: int
    threshold: float = 1.8      # step slower than 1.8x EMA -> strike
    max_strikes: int = 3
    decay: float = 0.9          # EMA smoothing of step time
    strike_decay: float = 0.5   # strikes *= this on every healthy step
    ema: Optional[float] = None
    strikes: dict = field(default_factory=dict)

    def observe(self, step_time: float,
                per_host: Optional[dict] = None) -> Decision:
        if self.ema is None:
            self.ema = step_time
            return Decision("ok")
        slow = step_time > self.threshold * self.ema
        self.ema = self.decay * self.ema + (1 - self.decay) * step_time
        if not slow:
            # healthy step: transient suspicions fade instead of
            # accumulating forever (two blips hours apart must not
            # count like a persistent straggler)
            self.strikes = {h: s * self.strike_decay
                            for h, s in self.strikes.items()
                            if s * self.strike_decay >= 0.5}
            return Decision("ok")
        suspects = []
        if per_host:
            worst = max(per_host, key=per_host.get)
            if per_host[worst] > self.threshold * self.ema:
                suspects = [worst]
        for h in suspects:
            self.strikes[h] = self.strikes.get(h, 0) + 1
            if self.strikes[h] >= self.max_strikes:
                # the evicted host leaves the job: the watchdog's world
                # shrinks with it and its strike history goes too
                self.n_hosts -= 1
                self.strikes.pop(h, None)
                return Decision("evict", hosts=(h,), new_world=self.n_hosts)
        return Decision("warn", hosts=tuple(suspects))


@dataclass(frozen=True)
class StragglerModel:
    """Seeded slow-node distribution: each rank independently straggles
    with probability ``slow_fraction``; a straggler's compute runs
    ``slowdown x`` slower, healthy ranks jitter uniformly in
    ``[1, 1 + jitter]``.  Deterministic in ``(seed, rank)`` via pure
    python hashing — the same multipliers on every backend and platform
    (no numpy/torch RNG involved)."""
    slow_fraction: float = 0.02
    slowdown: float = 2.0
    jitter: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.slow_fraction <= 1.0:
            raise ValueError("slow_fraction must be in [0, 1]")
        if self.slowdown < 1.0:
            raise ValueError("slowdown must be >= 1.0")
        if self.jitter < 0.0:
            raise ValueError("jitter must be >= 0")

    def multiplier(self, rank: int) -> float:
        # the JAX package's seed string: the same multipliers in both
        rng = random.Random(f"repro.ft.stragglers|{self.seed}|{rank}")
        if rng.random() < self.slow_fraction:
            return self.slowdown
        return 1.0 + self.jitter * rng.random()

    def multipliers(self, world: int) -> tuple[float, ...]:
        """Per-rank busy-time multipliers for ranks ``0..world-1``."""
        return tuple(self.multiplier(r) for r in range(world))

    def stage_multipliers(self, cfg) -> tuple[float, ...]:
        """Per-pipeline-stage multiplier: the MAX over the stage's ranks
        — synchronous collectives inside a stage are barriers, so the
        slowest member paces the whole stage.  Stage membership follows
        the placement-aware rank decomposition the Chakra exporter uses
        (``rank_coords``), so placement changes which ranks share a
        stage exactly as they do on the real grid."""
        from ..core.chakra import rank_coords
        pp = max(1, cfg.pp)
        mults = [1.0] * pp
        for r in range(cfg.world):
            s = rank_coords(r, cfg)["pp"] if pp > 1 else 0
            m = self.multiplier(r)
            if m > mults[s]:
                mults[s] = m
        return tuple(mults)

    def host_multipliers(self, world: int, *, ranks_per_host: int = 8
                         ) -> dict[int, float]:
        """Per-host view (max over the host's ranks) — the signal a
        coordinator would feed :meth:`StragglerWatchdog.observe`."""
        out: dict[int, float] = {}
        for r in range(world):
            h = r // ranks_per_host
            m = self.multiplier(r)
            if m > out.get(h, 0.0):
                out[h] = m
        return out

    def describe(self) -> str:
        return (f"slow_fraction={self.slow_fraction} x{self.slowdown} "
                f"jitter={self.jitter} seed={self.seed}")


def drive_watchdog(watchdog: StragglerWatchdog, healthy_step: float,
                   host_mults: dict, *, warmup: int = 3, steps: int = 20
                   ) -> list[Decision]:
    """Replay a straggler scenario through a watchdog: ``warmup`` clean
    steps to settle the EMA, then ``steps`` perturbed steps whose step
    time is the slowest host's multiple of ``healthy_step`` (barrier
    semantics).  Returns the decision sequence — the harness the tests
    (and example) use to evaluate detection policies against a known
    injected ground truth."""
    decisions = []
    for _ in range(warmup):
        decisions.append(watchdog.observe(healthy_step))
    for _ in range(steps):
        if not host_mults:
            decisions.append(watchdog.observe(healthy_step))
            continue
        worst = max(host_mults.values())
        per_host = {h: m * healthy_step for h, m in host_mults.items()}
        d = watchdog.observe(healthy_step * worst, per_host=per_host)
        decisions.append(d)
        if d.kind == "evict":
            for h in d.hosts:
                host_mults.pop(h, None)
    return decisions


def elastic_mesh_shape(world: int, *, model: int = 16) -> tuple[int, int]:
    """Largest (data, model) mesh fitting ``world`` chips after eviction —
    shrink the data axis first (re-sharding params over data is cheap
    with ZeRO/FSDP; the model axis would change every weight layout)."""
    data = world // model
    if data < 1:
        raise ValueError(f"cannot fit model axis {model} in world {world}")
    return (data, model)
