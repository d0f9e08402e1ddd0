"""Failure-domain model over a cluster topology (resilience layer).

RAPID-LLM-style resilience analysis needs an aggregate failure process
for the job: at 32K-GPU scale whole-system MTBF is minutes, and it is
the *sum* of per-component rates that matters, not any single part.
This module turns a :class:`~repro_torch.core.topology.ClusterTopology` whose
tiers carry ``mtbf`` annotations into that aggregate process:

* :class:`FailureDomain` — one class of failing unit (chips, nodes,
  rails) with its unit count under the job's world size, the per-unit
  MTBF, and how many ranks one unit failure takes down.
* :class:`FailureModel` — the set of domains; exposes the aggregate
  Poisson rate, the system MTBF, and deterministic-seed sampling of
  failure-time traces (:class:`FailureTrace`) used to cross-check the
  closed-form goodput in :mod:`repro_torch.ft.goodput` by Monte Carlo.

Everything here is pure python (no torch) so :mod:`repro_torch.core.dse` can
import it inside sweep workers.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["FailureDomain", "FailureEvent", "FailureTrace", "FailureModel"]


@dataclass(frozen=True)
class FailureDomain:
    """One class of failing unit.

    ``units`` is how many independent units of this class the job spans;
    ``mtbf`` the mean time between failures of ONE unit (seconds, an
    exponential rate); ``ranks_lost`` how many ranks a single unit
    failure removes (1 for a chip, 8 for an HGX node, ...).
    """
    name: str
    units: int
    mtbf: float
    ranks_lost: int = 1

    def __post_init__(self):
        if self.units < 0:
            raise ValueError(f"domain {self.name!r}: units must be >= 0")
        if self.mtbf <= 0:
            raise ValueError(f"domain {self.name!r}: mtbf must be > 0")
        if self.ranks_lost < 1:
            raise ValueError(f"domain {self.name!r}: ranks_lost must be >= 1")

    @property
    def rate(self) -> float:
        """Aggregate failure rate of this domain (failures/second)."""
        return self.units / self.mtbf


@dataclass(frozen=True)
class FailureEvent:
    """One sampled failure: wall-clock arrival time + attributed domain."""
    t: float
    domain: str
    ranks_lost: int = 1


@dataclass(frozen=True)
class FailureTrace:
    """A deterministic sampled failure history over ``horizon`` seconds."""
    events: tuple[FailureEvent, ...]
    horizon: float
    seed: int
    rate: float

    def __len__(self) -> int:
        return len(self.events)

    def times(self) -> tuple[float, ...]:
        return tuple(e.t for e in self.events)


@dataclass(frozen=True)
class FailureModel:
    """Aggregate failure process for one job on one cluster.

    Build with :meth:`from_topology` (reads ``Tier.mtbf`` annotations,
    with per-tier overrides) or directly from explicit domains.  The
    combined process is Poisson with rate = sum of domain rates — the
    standard superposition of independent exponential components.
    """
    domains: tuple[FailureDomain, ...]

    def __post_init__(self):
        object.__setattr__(self, "domains", tuple(self.domains))
        names = [d.name for d in self.domains]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate failure domains: {names}")

    @classmethod
    def from_topology(cls, topology, world: int, *,
                      chip_mtbf: Optional[float] = None,
                      overrides: Optional[dict] = None) -> "FailureModel":
        """Derive domains from a topology's ``mtbf`` annotations.

        ``chip_mtbf`` adds a per-rank domain (``world`` units, 1 rank
        each).  Each annotated tier contributes a domain whose unit
        count is the number of that tier's units the job occupies
        (``max(1, world // capacity)``) and whose failure takes down
        every rank in the unit (``min(capacity, world)``).  ``overrides``
        maps tier name -> mtbf, adding or replacing annotations without
        rebuilding the topology.
        """
        ov = dict(overrides or {})
        domains = []
        if chip_mtbf is not None:
            domains.append(FailureDomain("chip", world, chip_mtbf, 1))
        caps = topology.capacities() if topology is not None else ()
        tiers = topology.tiers if topology is not None else ()
        for tier, cap in zip(tiers, caps):
            mtbf = ov.pop(tier.name, tier.mtbf)
            if mtbf is None:
                continue
            units = max(1, world // cap)
            domains.append(
                FailureDomain(tier.name, units, mtbf, min(cap, world)))
        if ov:
            raise ValueError(
                f"mtbf overrides for unknown tiers: {sorted(ov)}")
        if not domains:
            raise ValueError(
                "no failure domains: annotate Tier.mtbf, pass chip_mtbf, "
                "or give mtbf overrides")
        return cls(tuple(domains))

    @property
    def rate(self) -> float:
        """Total failure rate of the job (failures/second)."""
        return sum(d.rate for d in self.domains)

    @property
    def system_mtbf(self) -> float:
        """Mean time between *any* failure anywhere in the job."""
        r = self.rate
        return math.inf if r == 0 else 1.0 / r

    def sample(self, horizon: float, *, seed: int = 0) -> FailureTrace:
        """Sample a failure trace over ``[0, horizon)`` seconds.

        Poisson arrivals at the aggregate rate (exponential gaps), each
        attributed to a domain with probability proportional to its
        rate.  Deterministic in ``seed`` — the same (model, horizon,
        seed) always yields the same trace, so Monte Carlo cross-checks
        are reproducible across backends and platforms.
        """
        if horizon <= 0:
            raise ValueError("horizon must be > 0 seconds")
        rate = self.rate
        # str seeds hash via sha512 (stable across platforms and
        # PYTHONHASHSEED); tuple seeds are deprecated.  The string is the
        # JAX package's, so both packages sample the same traces
        rng = random.Random(f"repro.ft.failures|{seed}")
        events: list[FailureEvent] = []
        if rate > 0:
            weights = [d.rate for d in self.domains]
            t = rng.expovariate(rate)
            while t < horizon:
                dom = rng.choices(self.domains, weights=weights)[0]
                events.append(FailureEvent(t, dom.name, dom.ranks_lost))
                t += rng.expovariate(rate)
        return FailureTrace(tuple(events), horizon, seed, rate)

    def describe(self) -> str:
        parts = [f"{d.name}:{d.units}u@{d.mtbf:.0f}s" for d in self.domains]
        mtbf = self.system_mtbf
        tail = "inf" if math.isinf(mtbf) else f"{mtbf:.0f}s"
        return " + ".join(parts) + f" -> system MTBF {tail}"
