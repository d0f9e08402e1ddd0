"""Self-profiling spans for the generator pipeline (observability
tentpole, piece 2).

A contextvar-scoped tracer with near-zero overhead when disabled: the
hot pipeline stages (assemble, distribute/lower, instantiate, simulate,
batched kernel dispatch, Chakra export, DSE sweeps) are wrapped in
``with span("stage", attr=...):`` blocks.  Disabled — the default —
``span()`` is one global check returning a shared no-op context
manager; no allocation, no clock read (guarded ≤2 % of the batched
sweep in the JAX package's ``benchmarks/perf_smoke.py``).

Enable with ``REPRO_TRACE=1`` in the environment (process-lifetime
recording — call :func:`take_events` / :func:`export` to harvest) or
scoped with::

    with repro_torch.obs.profiled() as prof:
        Scenario(spec).train(batch=64, seq=512).sweep(64, device="cpu")
    prof.summary()          # per-span-name total/self times
    prof.export("sweep_profile.json")   # Perfetto / chrome://tracing

Span records carry wall-clock ``ts``/``dur`` (perf_counter), thread id,
nesting depth (from a contextvar, so concurrent sweep workers nest
correctly), and free-form ``args``; export shares the Chrome-trace JSON
emitter with the simulated-execution timelines
(:mod:`repro_torch.obs.timeline`), so one Perfetto session can show where a
5000-config sweep spends its generator time.
"""
from __future__ import annotations

import contextvars
import functools
import os
import threading
import time
from dataclasses import dataclass, field

__all__ = ["span", "traced", "enabled", "enable", "disable", "profiled",
           "take_events", "export", "Profile", "SpanEvent"]

_enabled = False                      # module-global fast-path check
_events: list = []                    # finished SpanEvent records
_lock = threading.Lock()
_depth: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_span_depth", default=0)


@dataclass(frozen=True)
class SpanEvent:
    """One finished span (times in seconds on the perf_counter clock)."""
    name: str
    ts: float
    dur: float
    tid: int
    depth: int
    args: dict = field(default_factory=dict)


class _Noop:
    """Shared do-nothing context manager: the disabled fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw) -> "_Noop":          # parity with _Span.set
        return self


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "args", "_t0", "_tok")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def set(self, **kw) -> "_Span":
        """Attach attributes discovered mid-span (result sizes etc.)."""
        self.args.update(kw)
        return self

    def __enter__(self) -> "_Span":
        self._tok = _depth.set(_depth.get() + 1)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        depth = _depth.get() - 1
        _depth.reset(self._tok)
        ev = SpanEvent(name=self.name, ts=self._t0, dur=dur,
                       tid=threading.get_ident(), depth=depth,
                       args=self.args)
        with _lock:
            _events.append(ev)
        return False


def span(name: str, **args):
    """A profiling span context manager; a shared no-op when tracing is
    disabled (the common case — keep call sites unconditional)."""
    if not _enabled:
        return _NOOP
    return _Span(name, args)


def traced(name: str | None = None, **args):
    """Decorator form: ``@traced("dse.sweep")`` wraps the call in a
    span (name defaults to the function's qualified name)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            with span(label, **args):
                return fn(*a, **kw)
        return wrapper
    return deco


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def take_events(clear: bool = True) -> list:
    """Snapshot (and by default drain) the recorded spans."""
    with _lock:
        out = list(_events)
        if clear:
            _events.clear()
    return out


class Profile:
    """Harvested spans from one :func:`profiled` block."""

    def __init__(self, events: list):
        self.events: list[SpanEvent] = events

    def totals(self) -> dict:
        """Per-name aggregate: {name: {"count", "total_s", "self_s"}}.

        ``self_s`` subtracts the time spent in directly-nested child
        spans on the same thread, so exclusive costs are attributable."""
        out: dict[str, dict] = {}
        for e in self.events:
            rec = out.setdefault(e.name, {"count": 0, "total_s": 0.0,
                                          "self_s": 0.0})
            rec["count"] += 1
            rec["total_s"] += e.dur
            rec["self_s"] += e.dur
        # children charge their duration back to the innermost
        # enclosing span on the same thread
        by_tid: dict[int, list[SpanEvent]] = {}
        for e in self.events:
            by_tid.setdefault(e.tid, []).append(e)
        for evs in by_tid.values():
            evs.sort(key=lambda e: (e.ts, -e.dur))
            stack: list[SpanEvent] = []
            for e in evs:
                while stack and e.ts >= stack[-1].ts + stack[-1].dur:
                    stack.pop()
                if stack and e.depth > stack[-1].depth:
                    out[stack[-1].name]["self_s"] -= e.dur
                stack.append(e)
        return out

    def summary(self) -> str:
        rows = sorted(self.totals().items(),
                      key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'span':<32} {'count':>7} {'total_ms':>10} {'self_ms':>10}"]
        for name, rec in rows:
            lines.append(f"{name:<32} {rec['count']:>7} "
                         f"{rec['total_s'] * 1e3:>10.2f} "
                         f"{max(0.0, rec['self_s']) * 1e3:>10.2f}")
        return "\n".join(lines)

    def chrome_trace(self) -> dict:
        """Chrome-trace JSON dict (see :func:`repro_torch.obs.timeline.
        chrome_trace_events` for the schema conventions shared with the
        simulated-execution timelines)."""
        from .timeline import profile_chrome_trace
        return profile_chrome_trace(self.events)

    def export(self, path: str) -> str:
        import json
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


class _Profiled:
    """Context manager flipping the tracer on for a scoped block."""

    def __init__(self):
        self.profile = Profile([])

    def __enter__(self) -> Profile:
        self._was = _enabled
        self._mark = len(_events)
        enable()
        return self.profile

    def __exit__(self, *exc):
        global _enabled
        _enabled = self._was
        with _lock:
            self.profile.events = _events[self._mark:]
            del _events[self._mark:]
        return False


def profiled() -> _Profiled:
    """``with repro_torch.obs.profiled() as prof:`` — scoped tracing; the
    yielded :class:`Profile` fills when the block exits."""
    return _Profiled()


def export(path: str, *, clear: bool = True) -> str:
    """Export everything recorded so far (the ``REPRO_TRACE=1`` path)."""
    prof = Profile(take_events(clear=clear))
    return prof.export(path)


if os.environ.get("REPRO_TRACE", "").strip() not in ("", "0", "false",
                                                     "off"):
    enable()
