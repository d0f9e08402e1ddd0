"""The port's symbolic generator (``repro_torch.core``: assembly, distribute,
lowering, the compiled cost model, the DSE driver) against the JAX package's,
on the CPU.

Both are the same sympy + numpy code, and the reference's own
compiled-vs-sympy parity is exact, so results must be **equal**, not close:
every field of the SimResult (per-stage spans included) and of the
MemoryReport.
"""
import dataclasses

import pytest

from repro import Scenario, TPU_V5E
from repro.api import _engines
from repro.configs import ARCHS, get
from repro.core.dse import evaluate_point_compiled as jax_evaluate_compiled
from repro_torch.core import H100_HGX, dse
from repro_torch.core import TPU_V5E as PORT_TPU_V5E
from torch_port_helpers import port_cfg, port_engine

MODES = ("train", "serve")


def _scenario(spec, mode):
    """The workloads of tests/test_batched_parity.py."""
    sc = Scenario(spec)
    return sc.train(batch=8, seq=64) if mode == "train" \
        else sc.serve(batch=4, kv_len=128)


def _cfgs(sc, spec):
    """One dense pp=1 config and one pipelined 1f1b config per case, as
    ``test_batched_parity._cfgs``."""
    ep = spec.moe is not None
    return [sc.parallel(dp=2, tp=2, sp=True, ep=ep).cfg,
            sc.parallel(dp=2, tp=2, sp=True, pp=2, microbatches=2,
                        ep=ep).cfg]


def _engine_for(sc):
    return port_engine(sc.spec, sc.mode, batch=sc.batch, seq=sc.seq,
                       kv_len=sc.kv_len)[0]


def _assert_equal_points(got, want, ctx):
    assert dataclasses.asdict(got.sim) == dataclasses.asdict(want.sim), ctx
    assert dataclasses.asdict(got.mem) == dataclasses.asdict(want.mem), ctx
    assert got.mem.peak_bytes == want.mem.peak_bytes, ctx
    assert got.label == want.label, ctx


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ARCHS)
def test_compiled_equals_reference(name, mode):
    """build_graph + bind_env + CompiledBackend + evaluate_point_compiled of
    the port equal the JAX package's on every bundled arch's smoke spec."""
    spec = get(name).smoke
    sc = _scenario(spec, mode)
    jengine = _engines.engine(sc.spec, sc.mode, sc.env())
    engine = _engine_for(sc)
    for cfg in _cfgs(sc, spec):
        for recompute in ((False, True) if mode == "train" else (False,)):
            want = jax_evaluate_compiled(jengine, cfg, TPU_V5E,
                                         recompute=recompute, reuse=True)
            got = dse.evaluate_point_compiled(engine, port_cfg(cfg),
                                              PORT_TPU_V5E,
                                              recompute=recompute, reuse=True)
            _assert_equal_points(got, want,
                                 (name, mode, cfg.describe(), recompute))


def test_hardware_profiles_are_the_references():
    from repro.core import costmodel as jcm
    for port, ref in ((PORT_TPU_V5E, jcm.TPU_V5E), (H100_HGX, jcm.H100_HGX)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_enumerate_configs_equals_reference():
    from repro.core.dse import enumerate_configs as jax_enumerate
    kw = dict(max_pp=8, microbatches=(1, 8), schedule=("1f1b", "gpipe"))
    want = [dataclasses.asdict(c) for c in jax_enumerate(64, **kw)]
    got = [dataclasses.asdict(c) for c in dse.enumerate_configs(64, **kw)]
    assert got == want and len(got) > 100


def test_compiled_sweep_equals_reference():
    """dse.sweep(backend="compiled") on the qwen3-14b smoke spec, world 8:
    the same labels in the same order, the same skips, equal values."""
    spec = get("qwen3-14b").smoke
    sc = Scenario(spec).train(batch=8, seq=64)
    kw = dict(microbatches=(1, 2), schedule=("1f1b", "gpipe"))
    want = sc.sweep(8, **kw)
    engine, build, env, n_layers = port_engine(spec, "train", batch=8,
                                               seq=64)
    got = dse.sweep(build, env, 8, PORT_TPU_V5E, n_layers=n_layers,
                    name=spec.name, engine=engine, **kw)
    assert [p.label for p in got] == [p.label for p in want]
    assert len(got) > 0
    for p, q in zip(got, want):
        _assert_equal_points(p, q, p.label)
    assert [(s.reason, s.prefiltered) for s in got.skipped] \
        == [(s.reason, s.prefiltered) for s in want.skipped]


@pytest.mark.parametrize("option", ["verify", "resilience", "rank_by",
                                    "prove"],
                         ids=["verify", "resilience", "rank_by", "prove"])
def test_unported_options_raise(option):
    """Every option of the reference's ``dse.sweep`` runs in the port:
    ``verify=`` attaches the reference's STG007 diagnostics to the skipped
    configs, ``prove=`` the reference's certificate (the analysis slice);
    ``resilience=`` and ``rank_by="effective_goodput"`` (the ``ft`` slice)
    give the reference's ranking and scores."""
    from repro.ft import ResilienceSpec as JaxResilienceSpec
    from repro_torch.ft import ResilienceSpec
    spec = get("qwen3-14b").smoke
    engine, build, env, n_layers = port_engine(spec, "train", batch=8,
                                               seq=64)
    if option in ("verify", "prove"):
        got = dse.sweep(build, env, 8, PORT_TPU_V5E, n_layers=n_layers,
                        name=spec.name, engine=engine, microbatches=(1, 8),
                        **{option: True})
        want = Scenario(spec).train(batch=8, seq=64).sweep(
            8, microbatches=(1, 8), **{option: True})
        assert len(got) > 0 and [p.label for p in got] \
            == [p.label for p in want]
        for p, q in zip(got, want):
            _assert_equal_points(p, q, p.label)
        diags = [[(s.cfg.describe(), d.code, d.severity, d.message)
                  for d in s.diagnostics] for s in got.skipped]
        assert got.skipped and diags == [
            [(s.cfg.describe(), d.code, d.severity, d.message)
             for d in s.diagnostics] for s in want.skipped]
        if option == "verify":
            assert all(len(d) == 1 and d[0][1] == "STG007" for d in diags)
        else:
            assert got.certificates.ok and got.certificates.summary() \
                == want.certificates.summary()
        return
    kw = dict(rank_by="effective_goodput") if option == "rank_by" else {}
    got = dse.sweep(build, env, 8, PORT_TPU_V5E, n_layers=n_layers,
                    name=spec.name, engine=engine,
                    resilience=ResilienceSpec(mtbf=2e4, ckpt="parallel_fs"),
                    **kw)
    want = Scenario(spec).train(batch=8, seq=64).sweep(
        8, resilience=JaxResilienceSpec(mtbf=2e4, ckpt="parallel_fs"), **kw)
    assert len(got) > 0 and [p.label for p in got] == [p.label for p in want]
    for p, q in zip(got, want):
        _assert_equal_points(p, q, p.label)
        assert dataclasses.asdict(p.resilience) \
            == dataclasses.asdict(q.resilience), p.label
        assert p.effective_step_time == q.effective_step_time


def test_chrome_trace_is_not_ported_yet():
    """``Profile.chrome_trace`` (obs/timeline.py, now ported) gives what
    the reference's emitter makes of the same spans; the metrics snapshot
    carries the front door's cache stats, as the reference's does."""
    from repro import compiled_cache_stats
    from repro.obs.timeline import profile_chrome_trace
    from repro_torch.obs import metrics, spans
    with spans.profiled() as prof:
        with spans.span("x"):
            pass
    assert prof.totals()["x"]["count"] == 1
    assert prof.chrome_trace() == profile_chrome_trace(prof.events)
    assert set(metrics.snapshot()["caches"]) == set(compiled_cache_stats())
