"""Observability of the generator: structured logging, self-profiling spans
and pipeline metrics (own copies of ``repro.obs.log``, ``repro.obs.spans``
and ``repro.obs.metrics``).  The simulated-execution timelines
(``obs/timeline.py``) are not ported yet.
"""
from __future__ import annotations

from .log import configure as configure_logging
from .log import get_logger
from .metrics import (REGISTRY, counter, diff, gauge, histogram, snapshot)
from .spans import (Profile, enabled, profiled, span, take_events, traced)

__all__ = [
    "configure_logging", "get_logger",
    "REGISTRY", "counter", "gauge", "histogram", "snapshot", "diff",
    "span", "traced", "profiled", "enabled", "take_events", "Profile",
]
