"""``repro_torch``-namespaced structured logging (observability satellite).

Every module logs through :func:`get_logger`, which hands out children
of the single ``repro_torch`` root logger.  The root is configured ONCE, from
the environment:

* ``REPRO_LOG=debug|info|warning`` attaches a stderr handler at that
  level with a compact ``repro_torch.core.dse: message`` format — the
  breadcrumb channel for paths that otherwise degrade silently (batched
  backend per-config fallbacks, DSE prefilter skips).
* unset, the root gets a :class:`logging.NullHandler` and stays at
  ``WARNING`` — zero output, near-zero cost (disabled ``logger.debug``
  is one level comparison).

:func:`configure` re-applies the setup programmatically (tests,
notebooks) without touching the environment.
"""
from __future__ import annotations

import logging
import os

ROOT = "repro_torch"

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "warn": logging.WARNING,
           "error": logging.ERROR}

_configured = False


def configure(level: str | int | None = None, *,
              stream=None, force: bool = False) -> logging.Logger:
    """Configure the ``repro_torch`` root logger.

    ``level`` is a name from ``REPRO_LOG``'s vocabulary (or a numeric
    logging level); ``None`` reads the ``REPRO_LOG`` environment
    variable and falls back to a silent ``NullHandler`` setup when it
    is unset.  Idempotent unless ``force`` — repeated imports never
    stack handlers."""
    global _configured
    root = logging.getLogger(ROOT)
    if _configured and not force:
        return root
    if level is None:
        env = os.environ.get("REPRO_LOG", "").strip().lower()
        level = _LEVELS.get(env) if env else None
    elif isinstance(level, str):
        low = level.strip().lower()
        if low not in _LEVELS:
            raise ValueError(
                f"REPRO_LOG level {level!r} not in {sorted(_LEVELS)}")
        level = _LEVELS[low]
    for h in list(root.handlers):
        root.removeHandler(h)
    if level is None:
        root.addHandler(logging.NullHandler())
        root.setLevel(logging.WARNING)
    else:
        handler = logging.StreamHandler(stream)
        handler.setFormatter(logging.Formatter(
            "%(name)s: %(message)s"))
        root.addHandler(handler)
        root.setLevel(level)
    # never double-print through an application's root logger
    root.propagate = False
    _configured = True
    return root


def get_logger(name: str = "") -> logging.Logger:
    """A logger under the ``repro_torch`` namespace (``repro_torch.core.dse``
    for ``get_logger("repro_torch.core.dse")`` or ``get_logger(__name__)``).
    First call configures the root from ``REPRO_LOG``."""
    configure()
    if not name or name == ROOT:
        return logging.getLogger(ROOT)
    if not name.startswith(ROOT + ".") and name != ROOT:
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
