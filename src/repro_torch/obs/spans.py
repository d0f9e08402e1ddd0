"""Self-profiling spans for the generator pipeline and the serving path
(observability tentpole, piece 2).

A contextvar-scoped tracer with near-zero overhead when disabled: the
hot pipeline stages (assemble, distribute/lower, instantiate, simulate,
batched kernel dispatch, Chakra export, DSE sweeps) and the serving path
(``engine.*`` steps of ``serve.Engine``, ``model.*`` layer boundaries of
``models.lm``, ``mamba.ssm`` and ``moe.*`` inside ``models.layers``) are
wrapped in ``with span("stage", attr=...):`` blocks.  Disabled — the
default — ``span()`` is one global check returning a shared no-op context
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
their own ``id`` and the ``parent`` id of the span that encloses them, with
the nesting depth (from a contextvar, so concurrent sweep workers nest
correctly), and free-form ``args``; export shares the Chrome-trace JSON
emitter with the simulated-execution timelines
(:mod:`repro_torch.obs.timeline`), so one Perfetto session can show where a
5000-config sweep spends its generator time.

While tracing is enabled and a ``torch.profiler`` records, each span also
opens a ``torch.profiler.record_function`` of its name, so the kernels it
launches sit under the span's annotation on the device and the span on
the profiler's clock (:meth:`Profile.clock_offset` gives the offset between
the two clocks, :meth:`Profile.device_time` the device time under each
span name, :meth:`Profile.kernels` the device's work).  torch is looked up only among the loaded modules: this module
imports nothing beyond the standard library.
"""
from __future__ import annotations

import contextvars
import functools
import itertools
import os
import statistics
import sys
import threading
import time
from dataclasses import dataclass, field

__all__ = ["span", "traced", "enabled", "enable", "disable", "profiled",
           "take_events", "export", "Profile", "SpanEvent"]

_enabled = False                      # module-global fast-path check
# finished spans as tuples of SpanEvent's fields, made into SpanEvents when
# harvested (a frozen dataclass costs microseconds to build)
_events: list = []
_lock = threading.Lock()
# (id of the innermost open span, its depth + 1): 0 and 0 outside any span
_open: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_open_span", default=(0, 0))
_ids = itertools.count(1)


@dataclass(frozen=True)
class SpanEvent:
    """One finished span (times in seconds on the perf_counter clock);
    ``parent`` is the ``id`` of the enclosing span, 0 at the top."""
    name: str
    ts: float
    dur: float
    tid: int
    depth: int
    args: dict = field(default_factory=dict)
    id: int = 0
    parent: int = 0


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


def _profiler_range(name: str):
    """A ``record_function`` range of ``name``, entered, while a torch
    profiler records; else None.  A process that has not loaded torch runs
    no profiler."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("name", "args", "_t0", "_tok", "_id", "_up", "_rf")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def set(self, **kw) -> "_Span":
        """Attach attributes discovered mid-span (result sizes etc.)."""
        self.args.update(kw)
        return self

    def __enter__(self) -> "_Span":
        self._up = _open.get()
        self._id = next(_ids)
        self._tok = _open.set((self._id, self._up[1] + 1))
        self._rf = _profiler_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _open.reset(self._tok)
        ev = (self.name, self._t0, dur, threading.get_ident(), self._up[1],
              self.args, self._id, self._up[0])
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
        out = [SpanEvent(*ev) for ev in _events]
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
        spans (those whose ``parent`` is the span), so exclusive costs are
        attributable."""
        out: dict[str, dict] = {}
        names = {e.id: e.name for e in self.events}
        for e in self.events:
            rec = out.setdefault(e.name, {"count": 0, "total_s": 0.0,
                                          "self_s": 0.0})
            rec["count"] += 1
            rec["total_s"] += e.dur
            rec["self_s"] += e.dur
        for e in self.events:
            if e.parent in names:
                out[names[e.parent]]["self_s"] -= e.dur
        return out

    def ranges(self, prof, device: bool = False) -> dict:
        """{span name: sorted (start, end) in µs} of ``prof``'s events of
        the spans' names: the ranges they opened on the host, or with
        ``device`` their annotations on the device."""
        from torch.autograd import DeviceType
        names = {e.name for e in self.events}
        kind = DeviceType.CUDA if device else DeviceType.CPU
        out: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == kind and e.name in names:
                out.setdefault(e.name, []).append(
                    (e.time_range.start, e.time_range.end))
        return {k: sorted(v) for k, v in out.items()}

    def clock_offset(self, prof) -> dict | None:
        """The spans' perf_counter clock against the profiler's, from the
        ranges the spans opened in ``prof`` (a finished
        ``torch.profiler.profile``): ``offset_s``, the median over the
        spans of (span start - its range's start, in seconds), ``iqr_s``
        their interquartile range and ``pairs``.  A span name counts where
        it has as many spans as ranges, paired in order; None where none
        does."""
        ranges = self.ranges(prof)
        by_name: dict[str, list] = {}
        for e in self.events:
            by_name.setdefault(e.name, []).append(e.ts)
        diffs = []
        for name, starts in by_name.items():
            rs = ranges.get(name, [])
            if len(rs) == len(starts):
                diffs += [t - r[0] / 1e6 for t, r in zip(sorted(starts), rs)]
        if not diffs:
            return None
        q = statistics.quantiles(diffs, n=4) if len(diffs) > 1 \
            else diffs * 3
        return {"offset_s": statistics.median(diffs), "iqr_s": q[2] - q[0],
                "pairs": len(diffs)}

    def kernels(self, prof) -> list:
        """Sorted (start, end) in µs of the device's work in ``prof``: its
        device events other than the spans' annotations."""
        from torch.autograd import DeviceType
        names = {e.name for e in self.events}
        return sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name not in names
            and e.time_range.end > e.time_range.start)

    def device_time(self, prof) -> dict:
        """{span name: device seconds of the kernels inside the span's
        annotations on the device} of ``prof`` (a finished
        ``torch.profiler.profile`` with CUDA activity; empty without).  One
        stream runs a span's kernels back to back, so the kernels inside
        its annotation are its own; spans of one name must not nest."""
        spans = self.ranges(prof, device=True)
        kernels = self.kernels(prof)
        out = {}
        for name, sp in spans.items():
            total, j = 0.0, 0
            for s, e in kernels:
                while j < len(sp) and sp[j][1] <= s:
                    j += 1
                k = j
                while k < len(sp) and sp[k][0] < e:
                    total += min(e, sp[k][1]) - max(s, sp[k][0])
                    k += 1
            out[name] = total / 1e6
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
            self.profile.events = [SpanEvent(*ev)
                                   for ev in _events[self._mark:]]
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
