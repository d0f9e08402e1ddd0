"""Lightweight metrics registry for the generator pipeline
(observability tentpole, piece 3).

Counters, gauges, and histograms with a process-global default
registry.  Instruments are created on demand and are cheap enough to
bump unconditionally (one dict lookup + int add); nothing is exported
unless asked.

:func:`snapshot` is the one-stop telemetry API: it merges the live
registry with the engine-cache statistics already kept by the fluent
layer (``repro_torch.api.compiled_cache_stats`` — graph/engine/batched-engine
caches, including the eviction vs staleness re-wrap split) and, when a
sweep ran, the batched backend's kernel/batch stats.
"""
from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "snapshot", "diff",
           "format_snapshot", "format_diff", "reset"]

_HIST_BOUNDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


@dataclass
class Counter:
    """Monotonically increasing count (cache hits, skips, kernel calls)."""
    name: str
    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


@dataclass
class Gauge:
    """Point-in-time value (batch size, in-flight configs)."""
    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def add(self, v: float) -> None:
        self.value += v


@dataclass
class Histogram:
    """Fixed-bound histogram plus running sum/count/min/max.

    Bounds default to decades from 1µs to 100s — sized for wall-clock
    durations of pipeline stages."""
    name: str
    bounds: tuple = _HIST_BOUNDS
    counts: list = field(default_factory=list)
    total: float = 0.0
    count: int = 0
    vmin: float = float("inf")
    vmax: float = float("-inf")

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Registry:
    """Named instruments, created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, bounds: tuple = _HIST_BOUNDS) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name, bounds))
        return h

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def collect(self) -> dict:
        """Plain-dict dump of every instrument (JSON-serializable)."""
        with self._lock:
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for name, c in sorted(self._counters.items()):
                out["counters"][name] = c.value
            for name, g in sorted(self._gauges.items()):
                out["gauges"][name] = g.value
            for name, h in sorted(self._hists.items()):
                out["histograms"][name] = {
                    "count": h.count, "total": h.total, "mean": h.mean,
                    "min": (None if h.count == 0 else h.vmin),
                    "max": (None if h.count == 0 else h.vmax),
                    "bounds": list(h.bounds), "buckets": list(h.counts),
                }
            return out


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, bounds: tuple = _HIST_BOUNDS) -> Histogram:
    return REGISTRY.histogram(name, bounds)


def reset() -> None:
    REGISTRY.reset()


def snapshot(*, caches: bool = True) -> dict:
    """One merged telemetry snapshot: the live registry plus the fluent
    layer's cache statistics (graph/engine/batched-engine builds, hits,
    evictions, staleness re-wraps)."""
    snap = REGISTRY.collect()
    if caches:
        try:
            from ..api import compiled_cache_stats
            snap["caches"] = compiled_cache_stats()
        except Exception:       # api layer unavailable (partial install)
            snap["caches"] = {}
    return snap


def _flatten(snap: dict) -> dict:
    """Dotted-key scalar view of a snapshot, for diffing/printing."""
    flat: dict[str, float] = {}
    for name, v in snap.get("counters", {}).items():
        flat[f"counter.{name}"] = v
    for name, v in snap.get("gauges", {}).items():
        flat[f"gauge.{name}"] = v
    for name, h in snap.get("histograms", {}).items():
        flat[f"hist.{name}.count"] = h.get("count", 0)
        flat[f"hist.{name}.total"] = h.get("total", 0.0)
    for name, v in snap.get("caches", {}).items():
        if isinstance(v, (int, float)):
            flat[f"cache.{name}"] = v
    return flat


def diff(a: dict, b: dict) -> dict:
    """Per-metric delta ``b - a`` between two snapshots (union of keys;
    missing values count as 0)."""
    fa, fb = _flatten(a), _flatten(b)
    return {k: fb.get(k, 0) - fa.get(k, 0)
            for k in sorted(set(fa) | set(fb))}


def format_snapshot(snap: dict) -> str:
    lines = []
    flat = _flatten(snap)
    if not flat:
        return "(no metrics recorded)"
    width = max(len(k) for k in flat)
    for k, v in sorted(flat.items()):
        if isinstance(v, float) and not v.is_integer():
            lines.append(f"{k:<{width}}  {v:.6g}")
        else:
            lines.append(f"{k:<{width}}  {int(v)}")
    return "\n".join(lines)


def format_diff(delta: dict) -> str:
    changed = {k: v for k, v in delta.items() if v}
    if not changed:
        return "(no metric changed)"
    width = max(len(k) for k in changed)
    lines = []
    for k, v in sorted(changed.items()):
        sign = "+" if v > 0 else ""
        if isinstance(v, float) and not float(v).is_integer():
            lines.append(f"{k:<{width}}  {sign}{v:.6g}")
        else:
            lines.append(f"{k:<{width}}  {sign}{int(v)}")
    return "\n".join(lines)
