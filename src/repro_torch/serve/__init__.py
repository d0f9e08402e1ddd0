"""Serving: the runtime engine (continuous batching over decode steps).

The symbolic half of ``repro.serve`` (``Job`` / ``JobResult``, which predict
the same request timeline in closed form) belongs to the generator and comes
with its port; it is left out here.
"""
from .engine import Engine, Request, make_prefill, make_serve_step

__all__ = ["Engine", "Request", "make_prefill", "make_serve_step"]
