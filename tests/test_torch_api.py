"""The port's front door (``repro_torch.api``: ``Scenario`` -> ``Trace``,
the graph / engine / batched-engine / series caches, the deprecated
``core.generate`` shim, ``launch.preflight``) against the JAX package's,
mirroring tests/test_api.py on the CPU.

Same sympy + numpy code, so every Trace number (op and comm counts, comm
volume, FLOPs by category, simulate, memory, summary) and every compiled
sweep must be **equal** to the reference's; the batched backend on
``device="cpu"`` within rel 1e-6, the reference's parity budget.  Specs
are carried across with ``torch_port_helpers.port_spec``."""
import dataclasses
import warnings

import pytest

import repro
import repro.api as japi
import repro_torch
import repro_torch.api as api
from repro import ModelSpec
from repro.configs import get
from repro.core import MoESpec
from torch_port_helpers import both_packages, port_spec, report_rows

GPT = ModelSpec(name="gptish", n_layers=4, d_model=256, n_heads=8,
                n_kv_heads=4, d_ff=512, vocab=4096)
MOE = ModelSpec(name="moeish", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=4, d_ff=256, vocab=512, moe=MoESpec(8, 2, 2, 64))
PGPT = port_spec(GPT)
PAR = {"gpt-tp-sp-zero1": (GPT, dict(dp=2, tp=2, sp=True, zero1=True)),
       "gpt-pp-fsdp": (GPT, dict(dp=2, pp=2, microbatches=4, fsdp=True)),
       "gpt-cp-interleaved": (GPT, dict(cp=2, pp=2, microbatches=4,
                                        schedule="interleaved", vstages=2)),
       "moe-ep": (MOE, dict(dp=4, ep=True))}


def _trace_numbers(tr, hw):
    """Everything a Trace reports, as plain data."""
    w = tr.workload
    return {
        "op_counts": [tr.op_counts(s) for s in range(w.stages)],
        "comm_counts": [tr.comm_counts(s) for s in range(w.stages)],
        "comm_volume": [tr.comm_volume(s) for s in range(w.stages)],
        "flops_by_category": [tr.flops_by_category(s)
                              for s in range(w.stages)],
        "total_flops": tr.total_flops(),
        "simulate": dataclasses.asdict(tr.simulate(hw)),
        "simulate_recompute": dataclasses.asdict(
            tr.simulate(hw, recompute=True)),
        "memory": dataclasses.asdict(tr.memory()),
        "memory_last_stage": dataclasses.asdict(
            tr.memory(stage=w.stages - 1, recompute=True)),
        "summary": tr.summary(hw),
        "repr": repr(tr),
    }


@pytest.mark.parametrize("backend", ["compiled", "sympy"])
@pytest.mark.parametrize("case", list(PAR))
def test_trace_equals_reference(case, backend):
    jspec, par = PAR[case]
    out = {}
    for pkg, spec in both_packages(jspec):
        tr = (pkg.Scenario(spec).train(batch=8, seq=64).with_backend(backend)
              .parallel(**par).trace())
        out[pkg.__name__] = _trace_numbers(tr, pkg.H100_HGX)
    assert out["repro_torch"]["simulate"]["step_time"] > 0
    assert out["repro_torch"] == out["repro"]


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_serving_trace_equals_reference(mode):
    out = {}
    for pkg, spec in both_packages(GPT):
        sc = pkg.Scenario(spec)
        sc = sc.decode(batch=4, kv_len=256) if mode == "decode" \
            else sc.prefill(batch=4, seq=256)
        out[pkg.__name__] = _trace_numbers(sc.parallel(dp=2, tp=2).trace(),
                                           pkg.TPU_V5E)
    assert out["repro_torch"] == out["repro"]


def test_trace_matches_port_primitives():
    """The fluent Trace equals the port's own primitive pipeline."""
    from repro_torch.core import (ParallelCfg, apply_pipeline, bind_env,
                                  build_graph, distribute, instantiate,
                                  simulate, total_layers)
    tr = repro_torch.Scenario(PGPT).train(batch=8, seq=64) \
        .parallel(dp=2, pp=2, microbatches=4, fsdp=True).trace()
    cfg = ParallelCfg(axes={"dp": 2}, dp_axis="dp", fsdp=True, pp=2,
                      microbatches=4)
    env = bind_env(PGPT, batch=8, seq=64)
    g = build_graph(PGPT, mode="train").graph
    distribute(g, cfg, env)
    plan = apply_pipeline(g, cfg.pp, total_layers(PGPT))
    w = instantiate(g, cfg, env, plan, name="gptish/train")
    assert tr.op_counts() == w.op_counts()
    assert tr.comm_volume() == w.comm_volume()
    assert tr.simulate(repro_torch.TPU_V5E).step_time \
        == simulate(w, repro_torch.TPU_V5E).step_time


def _rows(res):
    return [(p.label, dataclasses.asdict(p.sim), dataclasses.asdict(p.mem))
            for p in res]


@pytest.mark.parametrize("search", ["full", "pareto", "bnb"])
def test_scenario_sweep_compiled_equals_reference(search):
    kw = dict(max_tp=4, microbatches=(1, 2), schedule=("1f1b", "gpipe"),
              search=search)
    res = {pkg.__name__: pkg.Scenario(spec).train(batch=32, seq=64)
           .sweep(16, pkg.H100_HGX, **kw)
           for pkg, spec in both_packages(GPT)}
    got, want = res["repro_torch"], res["repro"]
    assert len(got) > 0 and _rows(got) == _rows(want)
    assert [(s.reason, s.prefiltered) for s in got.skipped] \
        == [(s.reason, s.prefiltered) for s in want.skipped]
    assert (got.evaluated, got.visited, got.total) \
        == (want.evaluated, want.visited, want.total)


def test_scenario_sweep_batched_on_cpu():
    """The batched backend on the CPU (the cost_reduce wrapper's plain
    version): the compiled sweep's points and ranking within rel 1e-6."""
    sc = repro_torch.Scenario(PGPT).train(batch=32, seq=64)
    kw = dict(max_tp=4, microbatches=(1, 2))
    got = sc.with_backend("batched").sweep(16, repro_torch.H100_HGX,
                                           device="cpu", **kw)
    want = sc.sweep(16, repro_torch.H100_HGX, **kw)
    assert got.backend == "batched" and got.batch_stats["points"] == len(got)
    assert [p.label for p in got] == [p.label for p in want]
    for p, q in zip(got, want):
        for f in ("step_time", "compute_time", "comm_time"):
            assert getattr(p.sim, f) == pytest.approx(getattr(q.sim, f),
                                                      rel=1e-6)
        assert p.mem.peak_bytes == pytest.approx(q.mem.peak_bytes, rel=1e-6)


def test_batched_sweep_without_a_card_raises():
    """The default device is the card: with none, the batched sweep raises
    instead of carrying on on the CPU; compiled sweeps ignore ``device``."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    sc = repro_torch.Scenario(PGPT).train(batch=32, seq=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sc.with_backend("batched").sweep(4)
    assert len(sc.sweep(4, device="cuda")) > 0


def test_batched_cache_is_keyed_by_device():
    api.clear_graph_cache()
    env = repro_torch.Scenario(PGPT).train(batch=8, seq=64).env()
    cpu1 = api._batched_engines.engine(PGPT, "train", env, "cpu")
    cpu2 = api._batched_engines.engine(PGPT, "train", env, "cpu")
    assert cpu1 is cpu2 and str(cpu1.device) == "cpu"
    meta = api._batched_engines.engine(PGPT, "train", env, "meta")
    assert meta is not cpu1 and meta.engine is cpu1.engine
    assert api.compiled_cache_stats()["batched_engines"] == 2
    api.clear_graph_cache()


# ---- caches: one assembly per sweep, LRU bounds, staleness ---------------

def test_sweep_assembles_graph_exactly_once(monkeypatch):
    real_build = api.build_graph
    calls = []

    def spy(spec, *, mode="train", **kw):
        calls.append((spec.name, mode))
        return real_build(spec, mode=mode, **kw)

    monkeypatch.setattr(api, "build_graph", spy)
    api.clear_graph_cache()
    pts = repro_torch.Scenario(PGPT).train(batch=32, seq=64).sweep(
        world=16, max_tp=4, microbatches=2)
    assert len(pts) >= 16
    assert calls == [("gptish", "train")]
    assert api.graph_cache_stats()["builds"] == 1
    api.clear_graph_cache()


def test_traces_share_assembly_not_graphs():
    api.clear_graph_cache()
    sc = repro_torch.Scenario(PGPT).train(batch=8, seq=64)
    t1, t2 = sc.parallel(dp=2).trace(), sc.parallel(dp=2, fsdp=True).trace()
    assert t1.workload.comm_counts() != t2.workload.comm_counts()
    assert api.graph_cache_stats()["builds"] == 1
    assert t1.graph is not t2.graph
    assert {op.uid for op in t1.graph.ops}.isdisjoint(
        {op.uid for op in t2.graph.ops})
    api.clear_graph_cache()


def _env_for(batch):
    return repro_torch.Scenario(PGPT).train(batch=batch, seq=64).env()


def test_engine_cache_lru_eviction():
    api.clear_graph_cache()
    n = api._engines.maxsize
    engines = {b: api._engines.engine(PGPT, "train", _env_for(b))
               for b in range(1, n + 3)}
    assert len(api._engines._store) == n
    assert api._engines.engine(PGPT, "train", _env_for(n + 2)) \
        is engines[n + 2]
    assert api._engines.engine(PGPT, "train", _env_for(1)) is not engines[1]
    api.clear_graph_cache()


def test_batched_engine_cache_eviction_and_staleness():
    api.clear_graph_cache()
    n = api._batched_engines.maxsize
    first = api._batched_engines.engine(PGPT, "train", _env_for(1), "cpu")
    assert first.engine is api._engines.engine(PGPT, "train", _env_for(1))
    assert api._batched_engines.engine(PGPT, "train", _env_for(1),
                                       "cpu") is first
    for b in range(2, api._engines.maxsize + 3):
        api._batched_engines.engine(PGPT, "train", _env_for(b), "cpu")
    assert len(api._batched_engines._store) == n
    rebuilt = api._batched_engines.engine(PGPT, "train", _env_for(1), "cpu")
    assert rebuilt is not first and rebuilt.engine is not first.engine
    # a stale wrapper (its compiled engine cleared) is re-wrapped, and
    # counted as such, not as an eviction
    before = (api._batched_engines.stale_rewraps,
              api._batched_engines.evictions)
    with api._engines._lock:
        api._engines._store.clear()
    again = api._batched_engines.engine(PGPT, "train", _env_for(1), "cpu")
    assert again is not rebuilt
    assert api._batched_engines.stale_rewraps == before[0] + 1
    assert api._batched_engines.evictions == before[1]
    api.clear_graph_cache()


def test_cache_stats_keys_and_clear():
    api._batched_engines.engine(PGPT, "train", _env_for(4), "cpu")
    stats = api.compiled_cache_stats()
    assert set(stats) == set(japi.compiled_cache_stats())
    assert stats["batched_engines"] >= 1
    api.clear_graph_cache()
    stats = api.compiled_cache_stats()
    assert stats["engines"] == 0 and stats["batched_engines"] == 0
    assert api.graph_cache_stats() == {"size": 0, "builds": 0, "hits": 0,
                                       "evictions": 0}


# ---- fluent semantics ----------------------------------------------------

def test_fluent_semantics_equal():
    """Scenario builders give the reference's configs and descriptions."""
    for jspec in (GPT, MOE):
        out = {}
        for pkg, spec in both_packages(jspec):
            S = pkg.Scenario
            scs = [S(spec).parallel(dp=4, tp=2, cp=2, pp=2, fsdp=True,
                                    zero1=True),
                   S(spec).parallel(tp=4, fsdp=True, zero1=True, ep=True),
                   S(spec).parallel(tp=4, ep="tp"),
                   S(spec).schedule("interleaved", vstages=2)
                   .parallel(pp=2, microbatches=4),
                   S(spec).parallel(dp=2, tp=2).placement("tp", "dp"),
                   S(spec).serve(batch=4, kv_len=128),
                   S(spec).serve(batch=4, seq=128)]
            out[pkg.__name__] = [(dataclasses.asdict(sc.cfg), sc.describe(),
                                  sc.mode, sc.world) for sc in scs]
        assert out["repro_torch"] == out["repro"]
    sc = repro_torch.Scenario(PGPT)
    with pytest.raises(AttributeError):
        sc.batch = 4
    with pytest.raises(ValueError):
        repro_torch.Scenario(PGPT, mode="bogus")
    with pytest.raises(ValueError, match="backend"):
        repro_torch.Scenario(PGPT, backend="jax")


def test_trace_is_lazy_and_memoized():
    tr = repro_torch.Scenario(PGPT).train(batch=8, seq=64).parallel(
        dp=2).trace()
    assert tr._workload is None
    w = tr.workload
    assert tr.workload is w and tr.graph is tr.graph
    assert tr.simulate() is tr.simulate()
    assert tr.memory() is tr.memory()
    assert tr.memory(recompute=True) is not tr.memory()


def test_generate_shim_warns_and_matches():
    from repro_torch.core import ParallelCfg, generate
    cfg = ParallelCfg(axes={"dp": 2}, dp_axis="dp")
    with pytest.warns(DeprecationWarning):
        w, g, plan, env = generate(PGPT, cfg, batch=8, seq=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jw = repro.core.generate(GPT, repro.ParallelCfg(axes={"dp": 2},
                                                        dp_axis="dp"),
                                 batch=8, seq=64)[0]
    assert w.op_counts() == jw.op_counts()
    assert w.comm_counts() == jw.comm_counts()
    assert plan.pp == 1 and env is not None and g.ops


# ---- the verifier and the prover through the front door -------------------

@pytest.mark.parametrize("case", list(PAR))
def test_trace_verify_equals_reference(case):
    """``Trace.verify(include_graph=True, chakra=True)``: graph lint, comm
    and schedule checks and every stage's Chakra trace, the reference's
    report."""
    jspec, par = PAR[case]

    def run(pkg, spec):
        tr = pkg.Scenario(spec).train(batch=8, seq=64).parallel(**par) \
            .trace()
        return report_rows(tr.verify(include_graph=True, chakra=True)), \
            report_rows(tr.verify())
    (want, want_plain), (got, got_plain) = (
        run(pkg, spec) for pkg, spec in both_packages(jspec))
    assert got == want and got_plain == want_plain
    assert not got[0] and got[1]["trace_nodes"] > 0
    assert "graph_lint" in got[1] and "trace_nodes" not in got_plain[1]


def test_scenario_prove_equals_reference():
    """``Scenario.prove``: the reference's certificate (classes, lattice,
    verdicts, summary)."""
    def run(pkg, spec):
        cert = pkg.Scenario(spec).train(batch=8, seq=64).prove(
            8, pkg.H100_HGX)
        return (cert.summary(), cert.ok, cert.lattice_points, cert.configs,
                [(c.label, c.degrees, c.ok) for c in cert.classes],
                report_rows(cert.report))
    (want, got) = (run(pkg, spec) for pkg, spec in both_packages(GPT))
    assert got == want and got[1]
    assert "all invariants certified" in got[0]


@pytest.mark.parametrize("backend", ["compiled", "batched"])
def test_sweep_verify_and_prove_equal_reference(backend):
    """``sweep(verify=True, prove=True)``: the reference's points, skipped
    configs with their STG007 diagnostics, and certificate (the batched
    backend on ``device="cpu"``, within rel 1e-6)."""
    kw = dict(device="cpu") if backend == "batched" else {}
    res = repro_torch.Scenario(PGPT).train(batch=8, seq=64).with_backend(
        backend).sweep(8, verify=True, prove=True, microbatches=(1, 8), **kw)
    want = repro.Scenario(GPT).train(batch=8, seq=64).sweep(
        8, verify=True, prove=True, microbatches=(1, 8))
    assert [p.label for p in res] == [p.label for p in want]
    for p, q in zip(res, want):
        assert abs(p.sim.step_time - q.sim.step_time) \
            <= 1e-6 * q.sim.step_time, p.label
    assert res.skipped and [
        (s.cfg.describe(), s.reason, [(d.code, d.severity, d.node, d.message)
                                      for d in s.diagnostics])
        for s in res.skipped] == [
        (s.cfg.describe(), s.reason, [(d.code, d.severity, d.node, d.message)
                                      for d in s.diagnostics])
        for s in want.skipped]
    assert all(len(s.diagnostics) == 1 for s in res.skipped)
    assert res.certificates.summary() == want.certificates.summary()
    assert "proved:" in res.summary()


# ---- the launchers' pre-flight line ----------------------------------------

def test_preflight_equals_reference(capsys):
    from repro.launch.preflight import announce as jax_announce
    from repro.launch.preflight import preflight as jax_preflight
    from repro_torch.launch.preflight import announce, preflight
    jspec = get("qwen3-14b").smoke
    kw = dict(mode="decode", batch=4, seq=1, kv_len=128, dp=1)
    got = preflight(port_spec(jspec), **kw)
    assert got == jax_preflight(jspec, **kw)
    announce("serve", got)
    jax_announce("serve", got)
    a, b = capsys.readouterr().out.splitlines()
    assert a == b and "STAGE pre-flight:" in a


def test_serve_launcher_prints_preflight(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                       "--requests", "1", "--max-new", "2", "--slots", "1",
                       "--kv-len", "32"])
    out = capsys.readouterr().out
    assert len(done) == 1
    assert out.splitlines()[0].startswith("[serve] STAGE pre-flight: ")
    assert "on tpu-v5e" in out.splitlines()[0]
