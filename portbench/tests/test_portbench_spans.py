"""The program's own spans and counters read by ``portbench/spans.py`` at a
smoke size on the CPU: stretches S and B run beside the window and stretch
A, the metrics that read them give host numbers and no device number on
the CPU, the engine's counts over the window equal the closed loop's, the
idle gaps go to the innermost span; and a ``--trace 0`` run's result line
has the keys it had."""
from types import SimpleNamespace

import pytest
import torch

from portbench import core, manifest, spans
from portbench.tests.helpers import CELLS, fixed_clock, run, smoke

BENCH = manifest.Bench(manifest.HERE.parent)
HOST = ("enqueue_ms.decode", "engine_host_ms.decode",
        "moe_idle_experts.decode")


def _collect() -> dict:
    from repro_torch.obs import metrics
    return metrics.REGISTRY.collect()


def _stretches(cell: str, seed: int) -> tuple:
    """A smoke run of ``cell`` with the window (the registry diffed over
    it), S, the tracing cost's rounds, A and B, as a traced run would make
    them -> (the window, its counts, {metric: reading}, the report's lines,
    its checks)."""
    from repro_torch.obs import metrics
    sm = smoke(cell)
    device = torch.device("cpu")
    with fixed_clock():
        ctx = core.setup(cell, seed, device, cfg=sm["cfg"], mix=sm["mix"],
                         check=sm["check"])
        before = _collect()
        window = ctx.load.measure(sm["seconds"])
        counts = metrics.diff(before, _collect())
        s = spans.host_stretch(ctx)
        cost = spans.tracing_cost(ctx)
        a = core.traced(ctx)
        b = spans.device_stretch(ctx)
    ctx.load.release()
    rctx = SimpleNamespace(window=window, stretch=a, stretch_s=s,
                           stretch_b=b, cfg=ctx.cfg, mix=ctx.mix)
    kind = ctx.mix["kind"]
    names = [m for m in spans.METRICS
             if m.endswith(".decode") == (kind == "closed_loop")]
    names += [m["name"] for m in BENCH.per_layer(cell)]
    readings = {m: BENCH.reader(m)(rctx) for m in names}
    lines, checks = spans.report(kind, counts, s, b, readings, cost)
    return window, counts, readings, lines, checks


@pytest.mark.parametrize("cell", list(CELLS))
def test_stretches_s_and_b_give_the_metrics_that_read_them(cell):
    window, counts, readings, lines, checks = _stretches(cell, 2)
    decode = ".decode" in cell
    mine = [m for m in spans.METRICS if m.endswith(".decode") == decode]
    for m in mine:
        # a device number never comes from the CPU
        assert (readings[m] is not None) == (m in HOST), m
    text = "\n".join(lines)
    assert "spans cost: on/off" in text
    assert f"median of {spans.COST_ROUNDS} rounds" in text
    assert "spans without their range: none" in text
    assert "by innermost span" in text
    if decode:
        assert 0 <= readings["moe_idle_experts.decode"] < 100
        assert readings["enqueue_ms.decode"] > 0
        # the engine's counts over the window are the closed loop's own
        assert window["steps"] > 20
        assert counts["counter.engine.slot_steps"] == window["slot_steps"]
        assert counts["counter.engine.generated"] == window["generated"]
        inner, outer = checks["gen_share"]
        assert inner == outer == readings["gen_share.decode"]
        assert "spans S: ms a step enqueue=" in text
    assert "spans S: moe dropped/picks" in text


def test_readers_find_nothing_without_the_programs_stretches():
    ctx = SimpleNamespace(window={}, stretch={}, cfg={}, mix={})
    for m in spans.METRICS:
        assert BENCH.reader(m)(ctx) is None
    empty = SimpleNamespace(stretch_s={"spans": {}, "counters": {}},
                            stretch_b={"span_s": {}, "tokens": 8192})
    for m in spans.METRICS:
        assert BENCH.reader(m)(empty) is None


def test_idle_gaps_go_to_the_innermost_span():
    ranges = {"engine.step": [(0, 100)], "engine.forward": [(10, 60)],
              "model.moe": [(20, 30)]}
    kernels = [(5, 22), (28, 50), (55, 90)]
    # gaps by their middle: 0-5 in the step, 22-28 in moe, 50-55 in forward,
    # 90-120 (the last, 105) in none
    got = dict(spans.idle_by_span(kernels, ranges, (0, 120)))
    assert got == pytest.approx({"engine.step": 5e-6, "model.moe": 6e-6,
                                 "engine.forward": 5e-6,
                                 spans.HARNESS: 30e-6})
    assert dict(spans.idle_by_span(kernels, ranges)) == pytest.approx(
        {"model.moe": 6e-6, "engine.forward": 5e-6})


@pytest.mark.parametrize("cell", ["jamba52b.decode-chat8",
                                  "dsmoe16b.prefill-mix8k"])
def test_an_untraced_result_line_keeps_its_keys(cell):
    line, _ = run(cell, seed=6)
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert set(line["metrics"]) == {m["name"]
                                    for m in BENCH.end_to_end(cell)}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
