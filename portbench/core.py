"""One run of one cell: set-up, the measured window, the traced stretch,
the output check and the result line.  ``run.py`` checks the card and
calls ``run_cell``; the tests call it on the CPU at a smoke size."""
from __future__ import annotations

import gc
import importlib
import sys
import time
from types import SimpleNamespace

import torch

from . import manifest, roofline
from . import weights as W
from .reference.model import Reference

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole: ``repro_torch`` is
    not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def setup(cell_name: str, seed: int, device, bench=None, cfg=None, mix=None,
          check=None):
    """Everything a run needs before its window: config, spec, weights on
    the device, the kernels built (on the card), the load generator warmed up.
    ``cfg``, ``mix`` and ``check`` (a ``workloads/<cell>.json``: the
    limits, and which batches are judged) replace the cell's own (the CPU tests
    run the harness at a smoke size)."""
    marks = [("start", time.perf_counter())]
    from repro_torch.models import lm
    from . import spec as S
    bench = bench or manifest.Bench(manifest.HERE.parent)
    cell = bench.cell(cell_name)
    cfg = cfg or bench.config(cell["config"])
    check = check or bench.check(cell_name)
    ctx = SimpleNamespace(cell=cell, cfg=cfg, seed=int(seed), device=device,
                          mix=mix or bench.traffic(cell["traffic"]),
                          limits=check["limits"],
                          judged_batches=check.get("judged_batches", {}),
                          bench=bench)
    ctx.spec = S.port_spec(cfg)
    ctx.rt = S.runtime(cfg)
    marks.append(("import", time.perf_counter()))
    ctx.tree = W.make_weights(cfg, seed, device)
    W.check_against_port(ctx.tree, lm.param_axes(ctx.spec))
    from .kinds.common import sync
    sync(device)
    marks.append(("weights", time.perf_counter()))
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    marks.append(("build", time.perf_counter()))
    ctx.load = importlib.import_module(
        f"portbench.kinds.{ctx.mix['kind']}").Load(ctx)
    ctx.load.setup()
    sync(device)
    marks.append(("warmup", time.perf_counter()))
    ctx.setup_split = {name: t - marks[i][1]
                       for i, (name, t) in enumerate(marks[1:])}
    return ctx


def traced(ctx) -> dict:
    """The stretch after the window under the profiler: the load
    generator's own numbers, the trace's digest and the flash calls'
    bound."""
    from . import profiling
    calls = []
    names = {n for ns in profiling.RANGED.values() for n in ns}
    with profiling.ranged(), profiling.flash_calls(calls):
        st = ctx.load.trace(lambda: _profile(ctx.device))
    dig = profiling.digest(st.pop("prof"), names)
    st.update(dig)
    st["flash_calls"] = len(calls)
    st["flash_bound_s"] = sum(roofline.flash_bound_s(c) for c in calls)
    return st


def judge(ctx, control: bool = False) -> dict:
    """The output check, once the program's state is freed: the load generator's
    numbers against the reference (and the control's with ``control``)."""
    ref = Reference(ctx.cfg, ctx.tree, "fp32", ctx.cfg["assumed"]["moe_capacity_factor"])
    ctl = Reference(ctx.cfg, ctx.tree, "fp8", ctx.cfg["assumed"]["moe_capacity_factor"]) \
        if control else None
    return ctx.load.check(ref, ctl)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench=None, cfg=None, mix=None,
             check=None) -> tuple:
    """-> (result line as a dict, the check's lines for stderr)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx = setup(cell_name, seed, device, bench, cfg, mix, check)
    from .kinds.common import sync
    sync(device)
    setup_s = time.perf_counter() - t_start
    window = ctx.load.measure(seconds)
    stretch = traced(ctx) if trace else None
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    ctx.load.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = judge(ctx)
    judge_s = time.perf_counter() - t_judge
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in ctx.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in
             ctx.bench.data["end_to_end"] + ctx.bench.data["per_layer"]}
    metrics = {}
    if not trace:
        for m in ctx.bench.end_to_end(cell_name):
            v = setup_s if m["name"] == "setup_s" else window[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rctx = SimpleNamespace(window=window, stretch=stretch, cfg=ctx.cfg,
                               mix=ctx.mix)
        for m in ctx.bench.per_layer(cell_name):
            v = ctx.bench.reader(m["name"])(rctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(window["finished"]),
            "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = stretch["busy_s"]
        dev["window_s"] = stretch["wall_s"]
        line["breakdown"] = {"device_ops": stretch["device_ops"],
                             "idle_gaps": stretch["idle_gaps"]}
    line["checks"] = checks
    summary = {k: v for k, v in window.items() if isinstance(v, (int, float))}
    summary.update(setup_s=setup_s, judge_s=judge_s,
                   **{f"setup.{k}_s": v for k, v in ctx.setup_split.items()},
                   **{k: v for k, v in numbers.items() if k not in checks})
    lines = [f"run {cell_name} seed {seed}: " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in summary.items())]
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r} "
             f"({'met' if c['value'] <= c['limit'] else 'NOT MET'}; "
             f"{numbers.get('judged')} judged)" for k, c in checks.items()]
    return line, lines
