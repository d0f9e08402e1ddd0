"""The port's serving cost model (``repro_torch.core.serving``:
``DecodeSeries``, ``PhaseResult``, ``JobResult``; ``repro_torch.api.Job``)
against the JAX package's, mirroring tests/test_serving.py on the CPU.

Same sympy + numpy code, so closed-form decode totals, TTFT / TPOT,
KV bytes, Chakra job exports and ``Job.sweep`` rankings must be **equal**
to the reference's (byte for byte for the exports); a prefill on the
batched backend (``device="cpu"``) within rel 1e-6."""
import dataclasses
import json

import pytest

import repro
import repro_torch
from repro import ModelSpec
from repro.core import MoESpec
from repro.core.simulate import simulate as jax_simulate
from repro.core.simulate import sum_convex_series as jax_sum_convex
from repro_torch.core import serving as pserving
from repro_torch.core.simulate import simulate, sum_convex_series
from torch_port_helpers import (both_packages, check_both, dir_bytes,
                                report_rows, run_both)

TINY = ModelSpec(name="srv", n_layers=2, d_model=128, n_heads=4,
                 n_kv_heads=2, d_ff=256, vocab=1024)
WINDOWED = ModelSpec(name="srv-win", n_layers=2, d_model=128, n_heads=4,
                     n_kv_heads=2, d_ff=256, vocab=1024, window=96)
MOE = ModelSpec(name="srv-moe", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=4, d_ff=256, vocab=512,
                moe=MoESpec(n_experts=16, top_k=2, d_expert=64))
BATCH, KV0, STEPS = 4, 64, 32


def _result(res):
    """A JobResult as plain data: every phase (with its SimResult) and
    every derived metric."""
    return dataclasses.asdict(res), res.row(), res.tokens_per_s, \
        res.peak_kv_gb, res.describe()


# ---- closed form vs per-step replay ----------------------------------------

@pytest.mark.parametrize("jspec,t_checks", [
    (TINY, (0, 13, STEPS - 1)),
    (WINDOWED, (0, 31, 32, 33, STEPS - 1)),   # window hits at kv=96 (t=32)
], ids=["dense", "sliding-window"])
def test_decode_series_equal(jspec, t_checks):
    """Per-step workloads, step times and the closed-form total of a
    DecodeSeries: the reference's, bit for bit."""
    def series(pkg, spec):
        sc = pkg.Scenario(spec).decode(batch=BATCH, kv_len=KV0) \
            .parallel(dp=2, tp=2)
        mod = repro.core.serving if pkg is repro else pserving
        s = mod.DecodeSeries(lambda: sc.builder().graph, spec, sc.cfg,
                             batch=BATCH, kv0=KV0, steps=STEPS)
        hw = pkg.TPU_V5E
        sim = jax_simulate if pkg is repro else simulate
        steps = {t: ([(n.name, n.flops, n.bytes_accessed, n.out_bytes,
                       n.comm) for n in s.step_workload(t).nodes],
                     sim(s.step_workload(t), hw).step_time)
                 for t in t_checks}
        return steps, s.total_time(hw), s.kv_bytes(STEPS - 1), \
            s.kv_bytes(0, local=True), s.engine_calls
    ref, port = run_both(jspec, series)
    assert port[1][1] <= 12
    assert port == ref


def test_sum_convex_series_equal():
    for f, lo, hi in ((lambda t: 3.0 + 0.5 * t, 0, 511),
                      (lambda t: max(10.0, 2.0 * t), 0, 100)):
        assert sum_convex_series(f, lo, hi) == jax_sum_convex(f, lo, hi)
    total, n = sum_convex_series(lambda t: max(10.0, 2.0 * t), 0, 100)
    assert total == pytest.approx(sum(max(10.0, 2.0 * t)
                                      for t in range(101)), rel=1e-12)


# ---- Job metrics ------------------------------------------------------------

@pytest.mark.parametrize("jspec", [TINY, WINDOWED, MOE],
                         ids=["dense", "sliding-window", "moe"])
def test_job_evaluate_equal(jspec):
    """TTFT, TPOT, tokens/s, peak KV and every phase of a colocated
    generation: the reference's."""
    def evaluate(pkg, spec):
        par = dict(dp=2, ep=True) if spec.moe else dict(dp=2, tp=2)
        job = pkg.Scenario(spec).prefill(batch=BATCH, seq=KV0) \
            .parallel(**par).generation(out_tokens=STEPS + 1)
        return _result(job.evaluate(pkg.TPU_V5E))
    ref, port = run_both(jspec, evaluate)
    assert port[0]["ttft"] > 0 and port[0]["tpot"] > 0
    assert port == ref


def test_disaggregated_evaluate_and_export_equal(tmp_path):
    """A disaggregated job: its metrics and its multi-pool Chakra export
    (kv-transfer send/recv between the pools) are the reference's, and the
    reference's checks pass on the port's files."""
    def run(pkg, spec):
        job = pkg.Scenario(spec).prefill(batch=BATCH, seq=KV0) \
            .generation(out_tokens=9).disaggregate(
                prefill_pool=dict(tp=2), decode_pool=dict(dp=2, tp=2),
                kv_transfer=50e9)
        out = tmp_path / pkg.__name__
        n = job.export_chakra(str(out))
        return n, _result(job.evaluate(pkg.TPU_V5E)), dir_bytes(out)
    ref, port = run_both(TINY, run)
    assert port[0] == 2 + 4
    man = json.loads(port[2]["job.json"])
    assert man["pools"]["decode"]["offset"] == 2
    assert port[1][0]["disaggregated"] and port[1][0]["kv_transfer_time"] > 0
    assert port == ref
    rep = check_both("check_trace_dir", str(tmp_path / "repro_torch"))
    assert rep.ok, rep.render()


def test_colocated_export_equal(tmp_path):
    def run(pkg, spec):
        job = pkg.Scenario(spec).prefill(batch=BATCH, seq=KV0) \
            .parallel(dp=2, tp=2).generation(out_tokens=5)
        out = tmp_path / pkg.__name__
        return job.export_chakra(str(out)), dir_bytes(out)
    ref, port = run_both(TINY, run)
    assert port[0] == 4 and port == ref


def test_kv_transfer_bytes_invariant():
    """The handoff ships the global cache: the same bytes for every decode
    pool, and the reference's."""
    def bytes_seen(pkg, spec):
        job = pkg.Scenario(spec).prefill(batch=BATCH, seq=KV0) \
            .generation(out_tokens=17)
        return {job.disaggregate(prefill_pool=dict(tp=2), decode_pool=pool,
                                 kv_transfer=100e9)
                .evaluate(pkg.TPU_V5E).kv_transfer_bytes
                for pool in (dict(tp=4), dict(dp=4), dict(dp=2, tp=2))}
    ref, port = run_both(TINY, bytes_seen)
    assert len(port) == 1 and port == ref


# ---- Job.sweep ---------------------------------------------------------------

def _rows(points):
    return [p.row() for p in points]


def test_job_sweep_out_tokens_and_splits_equal():
    def sweep(pkg, spec):
        job = pkg.Scenario(spec).prefill(batch=8, seq=64) \
            .generation(out_tokens=17)
        pts = job.sweep(8, pkg.TPU_V5E, out_tokens=(9, 17), max_tp=4,
                        max_pp=1)
        spts = job.sweep(8, pkg.TPU_V5E, splits="auto", max_tp=4, max_pp=1)
        return _rows(pts), _rows(spts), [p.split for p in spts]
    ref, port = run_both(TINY, sweep)
    assert {r["out_tokens"] for r in port[0]} == {9, 17}
    assert port[1] and all(a + b == 8 for a, b in port[2])
    assert port == ref


def test_job_sweep_splits_on_batched_backend():
    """The per-split prefill sweep on the batched backend, on the CPU: the
    same rows as the compiled backend within rel 1e-6 (the tokens/s) and
    the same pools as the reference."""
    def sweep(pkg, spec, backend, **kw):
        job = pkg.Job.request(prefill=pkg.Scenario(spec).prefill(
            batch=8, seq=64).with_backend(backend), decode_steps=16)
        return job.sweep(8, pkg.TPU_V5E, splits="auto", max_tp=4, max_pp=2,
                         **kw)
    port_spec = both_packages(TINY)[1][1]
    got = sweep(repro_torch, port_spec, "batched", device="cpu")
    want = sweep(repro_torch, port_spec, "compiled")
    ref = sweep(repro, TINY, "compiled")
    assert got and [p.split for p in got] == [p.split for p in want]
    for p, q, r in zip(got, want, ref):
        assert p.prefill_cfg.describe() == q.prefill_cfg.describe() \
            == r.prefill_cfg.describe()
        assert p.decode_cfg.describe() == q.decode_cfg.describe()
        assert p.tokens_per_s == pytest.approx(q.tokens_per_s, rel=1e-6)
    assert _rows(want) == _rows(ref)


def test_sweep_prefill_only_and_disaggregated_equal():
    def sweep(pkg, spec):
        sc = pkg.Scenario(spec).prefill(batch=4, seq=64)
        a = sc.generation(out_tokens=1).sweep(4, pkg.TPU_V5E, max_pp=1)
        dj = sc.generation(out_tokens=9).disaggregate(
            prefill_pool=dict(tp=2), decode_pool=dict(dp=2),
            kv_transfer=1e9)
        b = dj.sweep(4, pkg.TPU_V5E, max_pp=1)
        c = sc.generation(out_tokens=9).sweep(4, pkg.TPU_V5E,
                                              out_tokens=(1, 9), max_pp=1)
        return _rows(a), _rows(b), _rows(c), \
            [p.result.kv_transfer_time for p in b]
    ref, port = run_both(TINY, sweep)
    assert all(r["out_tokens"] == 1 for r in port[0])
    assert set(port[3]) == {0.0}
    assert port == ref


def test_step_sims_respect_algorithm_overrides():
    def run(pkg, spec):
        job = (pkg.Scenario(spec).prefill(batch=BATCH, seq=KV0)
               .parallel(dp=2, tp=2).with_algorithm("AllReduce", "tree")
               .generation(out_tokens=2))
        return _result(job.evaluate(pkg.H100_HGX_POD))
    ref, port = run_both(TINY, run)
    dec = next(p for p in port[0]["phases"] if p["mode"] == "decode")
    assert dec["time"] == dec["step_last"] == dec["step_first"]
    assert port == ref


# ---- construction errors, as the reference's ----------------------------------

def test_construction_errors():
    spec = both_packages(TINY)[1][1]
    S = repro_torch.Scenario
    with pytest.raises(ValueError, match="kv_len"):
        S(spec).serve(batch=4)
    sc = S(spec).prefill(batch=4, seq=64)
    with pytest.raises(ValueError, match="kv_growth"):
        sc.phase(kv_growth=1)
    with pytest.raises(ValueError, match="out_tokens"):
        sc.generation(out_tokens=0)
    with pytest.raises(ValueError, match="serving prompt shape"):
        S(spec).train(batch=4, seq=64).generation(out_tokens=8)
    with pytest.raises(ValueError, match="partition"):
        sc.generation(out_tokens=4).sweep(8, splits=[(2, 4)])
    from repro_torch import serve
    assert serve.Job is repro_torch.Job and serve.Phase is repro_torch.Phase
    assert serve.JobResult is pserving.JobResult


def test_job_timeline_equal():
    def run(pkg, spec):
        job = (pkg.Scenario(spec).generation(out_tokens=32, batch=8, seq=256)
               .disaggregate(prefill_pool=dict(tp=2), decode_pool=dict(tp=1),
                             kv_transfer=True))
        return json.dumps(job.timeline().chrome_trace())
    ref, port = run_both(TINY, run)
    assert "pool kv-transfer" in port and port == ref


@pytest.mark.parametrize("deep", [True, False])
@pytest.mark.parametrize("disaggregated", [False, True],
                         ids=["colocated", "disaggregated"])
def test_job_verify_equals_reference(disaggregated, deep):
    """``Job.verify``: every phase's workload through the comm and schedule
    checks (the decode series at its first step), and with ``deep`` the
    job's Chakra export through ``check_trace_dir``: the reference's
    report, clean."""
    def run(pkg, spec):
        job = pkg.Scenario(spec).prefill(batch=4, seq=64) \
            .generation(out_tokens=4)
        if disaggregated:
            job = job.disaggregate(prefill_pool=dict(tp=2),
                                   decode_pool=dict(dp=2), kv_transfer=True)
        return report_rows(job.verify(deep=deep))
    want, got = run_both(TINY, run)
    assert got == want and not got[0]
    assert ("trace_files" in got[1]) is deep
