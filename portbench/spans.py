"""The program's own spans and counters (``repro_torch.obs``) read in two
stretches of a run, beside the benchmark's outside ranges (stretch A,
``core.traced``):

* **S** (``host_stretch``), before A: the program's tracing on, no
  profiler, since the profiler slows every later launch in its process.
  It gives the spans' host times (``Profile.totals``) and the registry's
  counts over the stretch (``metrics.diff``).
* **B** (``device_stretch``), after A: tracing on under ``torch.profiler``,
  where each span opens a profiler range of its name.  It gives the device
  time under each span (the program's ``Profile.device_time``), the idle
  gaps labelled by the innermost span open on the host at their middle
  (``harness`` outside every span), and the spans' clock against the
  profiler's.

Each runs the mix's own trace length (``trace_steps`` / ``trace_cycles``)
through the load generator's ``trace``.  ``tracing_cost`` times that length
with tracing off and on in ``COST_ROUNDS`` paired rounds, after S.
``report`` gives the stderr lines of S, B, the cost and the inside checks.
The per-layer metrics of ``METRICS`` read S and B from the reader context
(``stretch_s``, ``stretch_b``); where the program opened no span or kept no
counter, a reading is absent: its reader returns None."""
from __future__ import annotations

import bisect
import contextlib
import statistics
import time
from types import SimpleNamespace

from . import core

# the per-layer metrics that read S and B (``metrics/<name>.py``); a
# ``.decode`` one reads a closed-loop cell, a ``.prefill`` one a prefill cell
METRICS = ("enqueue_ms.decode", "engine_host_ms.decode",
           "moe_idle_experts.decode", "mamba_ssm_ms.prefill",
           "moe_route_ms.prefill")
HARNESS = "harness"          # idle time while the host was in no span
COST_ROUNDS = 6              # paired off / on rounds of ``tracing_cost``


def _collect() -> dict:
    from repro_torch.obs import metrics
    return metrics.REGISTRY.collect()


def _diff(before: dict) -> dict:
    from repro_torch.obs import metrics
    return metrics.diff(before, _collect())


def host_stretch(ctx) -> dict:
    """Stretch S: the load generator's trace with the program's tracing on
    and no profiler."""
    from repro_torch.obs import spans
    before = _collect()
    st = ctx.load.trace(spans.profiled)
    st["counters"] = _diff(before)
    st["spans"] = st.pop("prof").totals()
    return st


def tracing_cost(ctx) -> dict:
    """The cost of the program's tracing, paired: ``COST_ROUNDS`` rounds of
    the mix's trace length with tracing off and on, in turns (the first of
    each round alternating), as each round's on / off time and their
    median.  After S, so that the traced path's first use is not counted."""
    from repro_torch.obs import spans
    ratios = []
    for r in range(COST_ROUNDS):
        wall = {}
        for on in (False, True) if r % 2 == 0 else (True, False):
            wall[on] = ctx.load.trace(
                spans.profiled if on else contextlib.nullcontext)["wall_s"]
        ratios.append(wall[True] / wall[False])
    return {"ratios": ratios, "median": statistics.median(ratios)}


@contextlib.contextmanager
def _profiled(device):
    """``torch.profiler`` with the program's tracing on inside it; the
    yielded namespace gets ``t0`` / ``t1``, the host clock where its body
    starts and ends."""
    from repro_torch.obs import spans
    with core._profile(device) as prof, spans.profiled() as trace:
        both = SimpleNamespace(torch=prof, spans=trace,
                               t0=time.perf_counter())
        yield both
        both.t1 = time.perf_counter()


def device_stretch(ctx) -> dict:
    """Stretch B: the load generator's trace with the program's tracing on
    under ``torch.profiler``."""
    st = ctx.load.trace(lambda: _profiled(ctx.device))
    both = st.pop("prof")
    prof, trace = both.torch, both.spans
    offset = trace.clock_offset(prof)
    ends = None
    if offset is not None:
        ends = tuple((t - offset["offset_s"]) * 1e6
                     for t in (both.t0, both.t1))
    ranges = trace.ranges(prof)
    kernels = trace.kernels(prof)
    edges = None
    if ends and kernels:
        edges = (kernels[0][0] - ends[0],
                 ends[1] - max(e for _, e in kernels))
    st.update(span_s=trace.device_time(prof), busy_s=_busy_s(kernels),
              offset=offset,
              unranged=sorted(n for n, t in trace.totals().items()
                              if len(ranges.get(n, ())) != t["count"]),
              edges_us=edges,
              idle_by_span=idle_by_span(kernels, ranges, ends))
    return st


def _busy_s(kernels: list) -> float:
    """Seconds of the union of the sorted ``kernels``' intervals (µs)."""
    busy, hi = 0.0, None
    for s, e in kernels:
        if hi is None or s > hi:
            busy += e - s
            hi = e
        elif e > hi:
            busy += e - hi
            hi = e
    return busy / 1e6


def idle_by_span(kernels: list, ranges: dict, ends=None) -> list:
    """Idle device seconds by the innermost of the program's spans open on
    the host (``ranges``: their host ranges in µs) at each gap's middle
    (``HARNESS`` where none is), largest first.  The gaps lie between the
    sorted ``kernels``' busy intervals, and where ``ends`` (the stretch's
    start and end in the profiler's µs) is given, before the first kernel
    and after the last."""
    gaps = []
    hi = ends[0] if ends else (kernels[0][0] if kernels else None)
    for s, e in kernels:
        if s > hi:
            gaps.append((hi, s))
        hi = max(hi, e)
    if ends and hi is not None and ends[1] > hi:
        gaps.append((hi, ends[1]))
    host = sorted((s, e, n) for n, rs in ranges.items() for s, e in rs)
    starts = [h[0] for h in host]
    idle: dict = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = HARNESS
        # nested ranges: the latest-starting one still open at mid is the
        # innermost
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])]


def report(kind: str, window_counts: dict, s: dict, b: dict,
           readings: dict, cost: dict) -> tuple:
    """(the stderr lines of S, the cost, B and the inside checks, the
    checks as (spans, outside) numbers).  ``window_counts`` is the
    registry diffed over the window, ``readings`` the cell's per-layer
    metrics with those of ``METRICS``."""
    lines, checks = [], {}
    sp = s["spans"]
    if kind == "closed_loop":
        n = s["steps"]
        step = sp.get("engine.step", {}).get("total_s")
        sync = sp.get("engine.sync", {}).get("total_s")
        split = {"enqueue": readings.get("enqueue_ms.decode"),
                 "engine_host": readings.get("engine_host_ms.decode"),
                 "sync_wait": 1e3 * sync / n if sync is not None else None,
                 "harness": 1e3 * (s["wall_s"] - step) / n
                 if step is not None else None}
        lines.append("spans S: ms a step " + " ".join(
            f"{k}={v:.6g}" for k, v in split.items() if v is not None))
        gen = window_counts.get("counter.engine.generated")
        slots = window_counts.get("counter.engine.slot_steps")
        if slots:
            checks["gen_share"] = (100.0 * gen / slots,
                                   readings.get("gen_share.decode"))
    c = s["counters"]
    picks = c.get("counter.moe.picks")
    if picks:
        dropped = picks - c.get("device_counter.moe.kept", 0)
        lines.append(
            f"spans S: moe dropped/picks {dropped}/{picks}"
            f" = {dropped / picks:.6g}; experts used/read "
            f"{c.get('device_counter.moe.experts_used', 0)}/"
            f"{c.get('counter.moe.experts_read', 0)}")
    lines.append(f"spans cost: on/off {cost['median']:.6g} (median of "
                 f"{len(cost['ratios'])} rounds: " + " ".join(
                     f"{r:.4f}" for r in cost["ratios"]) + ")")
    off, edges = b.get("offset"), b.get("edges_us")
    idle = sum(v for _, v in b["idle_by_span"])
    lines.append(
        "spans B: offset_s="
        + (f"{off['offset_s']:.9g} iqr_us={off['iqr_s'] * 1e6:.6g} "
           f"pairs={off['pairs']}" if off else "none")
        + (f" first kernel {edges[0]:.6g} us after the start, the last "
           f"{edges[1]:.6g} us before the end" if edges else "")
        + f"; spans without their range: {b['unranged'] or 'none'}")
    lines.append(
        f"spans B: idle_s={b['wall_s'] - b['busy_s']:.6g} by innermost span "
        f"{idle:.6g}: "
        + " ".join(f"{k}={v:.6g}" for k, v in b["idle_by_span"][:12]))
    ms = {k: 1e3 * v for k, v in b["span_s"].items()}
    if kind == "closed_loop" and "model.moe" in ms:
        checks["moe_ms"] = (ms["model.moe"] / b["steps"],
                            readings.get("moe_ms.decode"))
    if kind != "closed_loop" and "model.mamba" in ms:
        checks["mamba_ms"] = (ms["model.mamba"] / (b["tokens"] / 1000.0),
                              readings.get("mamba_ms.prefill"))
    for name, (inner, outer) in checks.items():
        rel = inner / outer - 1.0 if inner is not None and outer else None
        lines.append(f"inside check {name}: spans {inner!r} outside "
                     f"{outer!r}" + (f" ({100.0 * rel:+.4f}%)"
                                     if rel is not None else ""))
    return lines, checks
