"""The port's serving path traced by its own spans and counters
(``repro_torch.obs``): off by default and then recording nothing, the spans
of one engine step nested as the layers are, the served tokens the same
with tracing on and off, the MoE routing's and the engine's counts against
the host's (through a registry reset too), and the spans as ranges of a
torch.profiler trace on its clock."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.models import init_params, layers
from repro_torch.obs import metrics, spans
from repro_torch.serve import Engine, Request


@pytest.fixture(autouse=True)
def _clean_obs():
    spans.disable()
    spans.take_events()
    metrics.reset()
    yield
    spans.disable()
    spans.take_events()
    metrics.reset()


def _served(arch: str, trace: bool) -> tuple:
    """A smoke engine of 2 slots over 3 requests -> (tokens by request, the
    spans' Profile or None)."""
    a = get(arch)
    params = init_params(a.smoke, a.runtime, device="cpu", seed=0)
    eng = Engine(a.smoke, a.runtime, params, batch_slots=2, kv_len=32,
                 device="cpu")
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=np.array([1 + rid, 2, 3]),
                           max_new=3))
    if trace:
        with spans.profiled() as prof:
            done = eng.run(max_steps=64)
    else:
        prof, done = None, eng.run(max_steps=64)
    return {r.rid: r.out for r in done}, prof, eng


def _counts() -> dict:
    """The registry's counters, host and device, that are not zero."""
    snap = metrics.REGISTRY.collect()
    both = {**snap["counters"], **snap.get("device_counters", {})}
    return {k: v for k, v in both.items() if v}


def test_off_by_default_records_nothing():
    assert spans.span("engine.step", step=3) is spans._NOOP
    _served("jamba-v0.1-52b", trace=False)
    assert spans.take_events() == []
    assert not any(k.startswith("moe.") for k in _counts())
    assert all(v == 0 for v in metrics.REGISTRY.collect().get(
        "device_counters", {}).values())


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-moe-16b"])
def test_tokens_equal_with_tracing_on_and_off(arch):
    off, _, _ = _served(arch, trace=False)
    on, prof, _ = _served(arch, trace=True)
    assert on == off and len(on) == 3
    assert prof.events


def test_spans_of_a_step_nest_as_the_layers():
    _, prof, eng = _served("jamba-v0.1-52b", trace=True)
    by_id = {e.id: e for e in prof.events}

    def parent(e):
        return by_id[e.parent].name if e.parent else None
    steps = [e for e in prof.events if e.name == "engine.step"]
    assert len(steps) == eng.steps
    assert sorted(e.args["step"] for e in steps) == list(range(eng.steps))
    want = {"engine.step": {None}, "engine.tokens": {"engine.step"},
            "engine.forward": {"engine.step"}, "engine.sync": {"engine.step"},
            "mamba.ssm": {"model.mamba"}, "moe.dispatch": {"model.moe"},
            "moe.combine": {"model.moe"}}
    for name in ("model.embed", "model.mamba", "model.attn", "model.moe",
                 "model.ffn", "model.logits"):
        want[name] = {"engine.forward"}
    got = {}
    for e in prof.events:
        got.setdefault(e.name, set()).add(parent(e))
        if e.parent:
            assert by_id[e.parent].depth == e.depth - 1
    assert got == want
    tot = prof.totals()
    children = sum(tot[k]["total_s"] for k in
                   ("engine.tokens", "engine.forward", "engine.sync"))
    assert tot["engine.step"]["self_s"] == pytest.approx(
        tot["engine.step"]["total_s"] - children)


@pytest.mark.parametrize("capacity_factor, drops", [(1.25, False),
                                                     (0.25, True)])
def test_moe_counts_equal_the_hosts(capacity_factor, drops):
    g = torch.Generator().manual_seed(5)
    E, Kk = 8, 2
    h = torch.randn(2, 12, 16, generator=g)
    wr = torch.randn(16, E, generator=g)
    kw = dict(E=E, Kk=Kk, capacity_factor=capacity_factor)
    with spans.profiled() as prof:
        route = layers.moe_dispatch(h, wr, **kw)
        layers.moe_dispatch(h, wr, **kw)
    used = len(set(route["se"][route["keep"]].tolist()))
    kept = int(route["keep"].sum())
    assert (kept < 24 * Kk) == drops
    assert _counts() == {"moe.experts_used": 2 * used, "moe.kept": 2 * kept,
                         "moe.picks": 2 * 24 * Kk, "moe.experts_read": 2 * E}
    assert [e.name for e in prof.events] == ["moe.dispatch"] * 2
    metrics.reset()
    assert _counts() == {}


@pytest.mark.parametrize("reset", [False, True])
def test_engine_counts_equal_the_hosts(reset):
    """A closed loop of 3 slots, each finished request replaced by a new
    one: slot steps and served tokens counted on the host; with ``reset``
    the registry is reset after the engine took its counters."""
    a = get("deepseek-moe-16b")
    params = init_params(a.smoke, a.runtime, device="cpu", seed=0)
    eng = Engine(a.smoke, a.runtime, params, batch_slots=3, kv_len=64,
                 device="cpu")
    reqs = []

    def submit():
        n = len(reqs)
        reqs.append(Request(rid=n, prompt=np.arange(1, 2 + n % 3),
                            max_new=1 + n % 4))
        eng.submit(reqs[-1])
    for _ in range(3):
        submit()
    if reset:
        metrics.counter("engine.generated").inc(5)
        metrics.reset()
    before = metrics.REGISTRY.collect()
    for _ in range(14):
        for _ in eng.run(max_steps=1):
            submit()
    c = metrics.diff(before, metrics.REGISTRY.collect())
    generated = sum(len(r.out) for r in reqs)
    assert eng.steps == 14 and sum(r.done for r in reqs) >= 4
    assert c["counter.engine.slot_steps"] == 3 * 14
    assert 0 < c["counter.engine.generated"] == generated < 3 * 14
    if reset:
        assert metrics.counter("engine.generated").value == generated


def test_spans_are_profiler_ranges_on_its_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    a = get("deepseek-moe-16b")
    params = init_params(a.smoke, a.runtime, device="cpu", seed=0)
    eng = Engine(a.smoke, a.runtime, params, batch_slots=2, kv_len=32,
                 device="cpu")
    eng.submit(Request(rid=0, prompt=np.array([1, 2, 3]), max_new=4))
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            spans.profiled() as trace:
        eng.run(max_steps=64)
    count = {}
    for e in trace.events:
        count[e.name] = count.get(e.name, 0) + 1
    ranges = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in count:
            ranges[e.name] = ranges.get(e.name, 0) + 1
    assert ranges == count and "engine.forward" in count
    off = trace.clock_offset(prof)
    assert off["pairs"] == len(trace.events)
    assert math.isfinite(off["offset_s"]) and 0 <= off["iqr_s"] < 0.01
    assert trace.device_time(prof) == {}
    # no profiler recording: a span opens no range
    with spans.profiled() as quiet:
        with spans.span("x"):
            assert not torch.autograd._profiler_enabled()
    assert [e.name for e in quiet.events] == ["x"]


def _event(name, start, end, device):
    from torch.autograd import DeviceType
    kind = DeviceType.CUDA if device else DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end))


def test_device_time_is_the_kernels_inside_each_annotation():
    """Kernels clipped to the span's annotations on the device; a kernel
    outside every annotation counts for none."""
    trace = spans.Profile([spans.SpanEvent("model.moe", 0.0, 1.0, 0, 0),
                           spans.SpanEvent("model.moe", 2.0, 1.0, 0, 0)])
    prof = SimpleNamespace(events=lambda: [
        _event("model.moe", 100, 200, True), _event("model.moe", 300, 340,
                                                     True),
        _event("gemm", 110, 150, True), _event("gemm", 190, 230, True),
        _event("sort", 250, 260, True), _event("gemm", 300, 320, True),
        _event("model.moe", 90, 400, False)])
    assert trace.device_time(prof) == {"model.moe": pytest.approx(
        (40 + 10 + 20) / 1e6)}


def test_serve_preflight_is_priced_for_the_card(monkeypatch, capsys):
    from repro_torch.launch import serve
    spec = get("qwen3-14b").smoke
    serve.announce_preflight(spec, slots=4, kv_len=128,
                             device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    serve.announce_preflight(spec, slots=4, kv_len=128,
                             device=torch.device("cuda"))
    cpu, cuda = capsys.readouterr().out.splitlines()
    assert cpu.startswith("[serve] STAGE pre-flight: ")
    assert cpu.endswith("on tpu-v5e") and cuda.endswith("on h100-hgx")

