"""The traced stretch: ``record_function`` ranges put from outside around
functions of the port's modules, a recorder of every flash-attention call's
shapes, and the digest of a ``torch.profiler`` trace into device-busy time,
device time under each range, flash kernel time, the top device operations
and the idle gaps by what the host was doing."""
from __future__ import annotations

import bisect
import contextlib
import importlib
from collections import defaultdict

# module -> functions that run inside a range of their own name while a
# stretch is traced
RANGED = {
    "repro_torch.models.layers": ("moe_ffn", "mamba_layer", "gqa_attention",
                                  "ffn"),
    "repro_torch.models.lm": ("_logits",),
}
FLASH_TAG = "flash"          # in the name of every flash-attention kernel


@contextlib.contextmanager
def ranged():
    """Wrap the functions of ``RANGED`` in ranges of their names; restored
    on exit."""
    from torch.profiler import record_function
    saved = []
    for modname, names in RANGED.items():
        mod = importlib.import_module(modname)
        for name in names:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def call(*a, _fn=fn, _name=name, **kw):
                with record_function(_name):
                    return _fn(*a, **kw)
            setattr(mod, name, call)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def flash_calls(calls: list):
    """Record every call of ``kernels.ops.flash_attention`` (the entry the
    model's attention goes through) as the shapes, element size and masking
    that ``roofline.flash_bound_s`` reads."""
    ops = importlib.import_module("repro_torch.kernels.ops")
    fn = ops.flash_attention

    def call(q, k, v, *, causal=True, window=None, softcap=None, q_offset=0):
        calls.append({"q": tuple(q.shape), "k": tuple(k.shape),
                      "v": tuple(v.shape), "esize": q.element_size(),
                      "causal": bool(causal), "window": window,
                      "q_offset": int(q_offset)})
        return fn(q, k, v, causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
    ops.flash_attention = call
    try:
        yield
    finally:
        ops.flash_attention = fn


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def digest(prof, range_names: set) -> dict:
    """What the per-layer readers and the breakdown take from one trace."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    kernels = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in events
         if e.device_type == DeviceType.CUDA and e.name not in range_names
         and e.time_range.end > e.time_range.start),
        key=lambda k: k[0])
    out = {"kernels": len(kernels), "busy_s": 0.0, "range_s": {},
           "flash_s": 0.0, "flash_kernels": 0, "device_ops": [],
           "idle_gaps": []}
    if not kernels:
        return out
    # busy: the union of the kernels' intervals; the gaps between its pieces
    busy, gaps = 0.0, []
    lo, hi = kernels[0][0], kernels[0][1]
    for s, e, _ in kernels[1:]:
        if s > hi:
            busy += hi - lo
            gaps.append((hi, s))
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    out["busy_s"] = busy / 1e6
    by_name = defaultdict(float)
    for s, e, name in kernels:
        by_name[name] += (e - s) / 1e6
        if FLASH_TAG in name.lower():
            out["flash_s"] += (e - s) / 1e6
            out["flash_kernels"] += 1
    out["device_ops"] = [[n[:96], v] for n, v in
                         sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    # device time under each range: the kernels inside the range's spans on
    # the device (its annotation events; one stream runs a range's kernels
    # back to back, and no other kernel between them)
    spans = defaultdict(list)
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name in range_names:
            spans[e.name].append((e.time_range.start, e.time_range.end))
    ranges = {name: _inside(kernels, sorted(sp)) for name, sp in spans.items()}
    out["range_s"] = {k: v / 1e6 for k, v in ranges.items()}
    out["idle_gaps"] = _label_gaps(events, gaps, range_names)
    return out


def _inside(kernels, spans) -> float:
    """Microseconds of the sorted ``kernels`` that fall inside the sorted,
    disjoint ``spans``."""
    total, j = 0.0, 0
    for s, e, _ in kernels:
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < e:
            total += min(e, spans[k][1]) - max(s, spans[k][0])
            k += 1
    return total


def _label_gaps(events, gaps, range_names) -> list:
    """Idle device time summed by what the host was doing at each gap's
    middle: the innermost host event there, under its outermost range."""
    from torch.autograd import DeviceType
    host = sorted(((e.time_range.start, e.time_range.end, e) for e in events
                   if e.device_type == DeviceType.CPU),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        inner = None
        for j in range(i, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                inner = host[j][2]
                break
        label = "host: between ops"
        if inner is not None:
            outer, p = None, inner
            while p is not None:
                if p.name in range_names:
                    outer = p.name
                p = p.cpu_parent
            label = f"{outer}/{inner.name}" if outer and outer != inner.name \
                else inner.name
        idle[label[:96]] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
