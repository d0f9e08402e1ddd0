"""Observability layer: simulated-execution timelines, self-profiling
spans, and pipeline metrics.

Three coupled pieces (see each module's docstring):

* :mod:`repro_torch.obs.timeline` — Perfetto/Chrome-trace export of the
  *modeled* execution (schedule replay slots, compute/comm streams,
  collectives, resilience epochs, serving pool lanes) plus the derived
  :class:`~repro_torch.obs.timeline.UtilizationReport`.  Reached through
  ``Trace.timeline(...)`` / ``Job.timeline(...)``.
* :mod:`repro_torch.obs.spans` — self-profiling tracer for the generator
  itself (``REPRO_TRACE=1`` or :func:`profiled`), same export format.
* :mod:`repro_torch.obs.metrics` — counters/gauges/histograms +
  :func:`snapshot`/:func:`diff`, surfaced by ``python -m repro_torch.obs``.

``spans``/``metrics``/``log`` are stdlib-only and import eagerly;
``timeline`` depends on the core simulation layer and loads lazily so
``repro_torch.core`` modules can import ``repro_torch.obs`` without a cycle.
"""
from __future__ import annotations

from .log import configure as configure_logging
from .log import get_logger
from .metrics import (REGISTRY, counter, device_counter, diff, gauge,
                      histogram, snapshot)
from .spans import (Profile, enabled, profiled, span, take_events, traced)

__all__ = [
    "configure_logging", "get_logger",
    "REGISTRY", "counter", "device_counter", "gauge", "histogram", "snapshot", "diff",
    "span", "traced", "profiled", "enabled", "take_events", "Profile",
    # lazy (from .timeline):
    "Timeline", "TimelineEvent", "UtilizationReport",
    "build_timeline", "job_timeline", "profile_chrome_trace",
    "validate_chrome_trace",
]

_TIMELINE_NAMES = {"Timeline", "TimelineEvent", "UtilizationReport",
                   "build_timeline", "job_timeline",
                   "profile_chrome_trace", "validate_chrome_trace"}


def __getattr__(name: str):
    if name in _TIMELINE_NAMES:
        from . import timeline as _tl
        return getattr(_tl, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
