"""The port's batched backend (``repro_torch.core.batched``, on the CPU)
against the compiled backend, mirroring tests/test_batched_parity.py.

The batched backend must reproduce the compiled backend — the port's is
equal to the JAX package's (tests/test_torch_generator.py), and both are
pinned exactly against the sympy reference — within rel 1e-6 on every
bundled architecture in train and serve mode, which needs float64 (a
regression test shows float32 is NOT enough).  Here the JAX package's
compiled backend is the yardstick, so every case holds the port against
the reference directly.

Tolerances (the reference's): step/compute/comm/peak-memory components at
rel 1e-6; exposed comm and bubble fraction are differences of near-equal
quantities (span - busy), so they are compared with an absolute tolerance
scaled by the step time.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import Scenario, TPU_V5E
from repro.api import _engines
from repro.configs import ARCHS, get
from repro.core.dse import evaluate_point_compiled as jax_evaluate_compiled
from repro_torch.core import TPU_V5E as PORT_TPU_V5E
from repro_torch.core import dse
from repro_torch.core.batched import REPLAYABLE_SCHEDULES, BatchedBackend
from repro_torch.kernels import cost_reduce as cr
from torch_port_helpers import port_cfg, port_engine

MODES = ("train", "serve")
REL = 1e-6

try:
    from benchmarks.paper_models import GPT3_5B
except ImportError:
    from repro.core import ModelSpec
    GPT3_5B = ModelSpec(name="gpt3-5b", n_layers=24, d_model=4096,
                        n_heads=32, n_kv_heads=32, d_ff=16384, vocab=51200,
                        gated_ffn=False)

GPT3_SMOKE = dataclasses.replace(GPT3_5B, name="gpt3-5b-smoke", n_layers=8,
                                 d_model=2048, n_heads=16, n_kv_heads=16,
                                 d_ff=8192, vocab=4096)


def _scenario(spec, mode):
    sc = Scenario(spec)
    return sc.train(batch=8, seq=64) if mode == "train" \
        else sc.serve(batch=4, kv_len=128)


def _cfgs(sc, spec):
    ep = spec.moe is not None
    return [sc.parallel(dp=2, tp=2, sp=True, ep=ep).cfg,
            sc.parallel(dp=2, tp=2, sp=True, pp=2, microbatches=2,
                        ep=ep).cfg]


def _port(sc, **kw):
    """(JAX compiled engine, the port's BatchedBackend on the CPU)."""
    engine = port_engine(sc.spec, sc.mode, batch=sc.batch, seq=sc.seq,
                         kv_len=sc.kv_len)[0]
    return (_engines.engine(sc.spec, sc.mode, sc.env()),
            BatchedBackend(engine, device="cpu", **kw))


def _assert_sim_close(sim_b, sim_c, ctx):
    step = sim_c.step_time
    for attr in ("step_time", "compute_time", "comm_time"):
        a, b = getattr(sim_c, attr), getattr(sim_b, attr)
        assert abs(a - b) <= REL * max(abs(a), 1e-30), (ctx, attr, a, b)
    assert abs(sim_c.exposed_comm - sim_b.exposed_comm) <= REL * step, ctx
    assert abs(sim_c.bubble_fraction - sim_b.bubble_fraction) <= REL, ctx
    assert sim_b.schedule == sim_c.schedule, ctx


def _assert_mem_close(mem_b, mem_c, ctx):
    for f in ("weights", "grads", "opt_states", "master_params",
              "peak_activation", "recompute_extra", "peak_bytes"):
        a, b = getattr(mem_c, f), getattr(mem_b, f)
        assert abs(a - b) <= REL * max(abs(a), 1e-30), (ctx, f, a, b)
    assert mem_b.inflight_factor == mem_c.inflight_factor, ctx


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ARCHS)
def test_batched_parity(name, mode):
    spec = get(name).smoke
    sc = _scenario(spec, mode)
    jengine, bengine = _port(sc)
    cfgs = _cfgs(sc, spec)
    for recompute in ((False, True) if mode == "train" else (False,)):
        before = cr.launches
        got = bengine.evaluate_many([port_cfg(c) for c in cfgs],
                                    PORT_TPU_V5E, recompute=recompute)
        assert cr.launches == before          # the CPU runs the plain version
        assert all(r is not None for r in got)
        for cfg, (sim_b, mem_b) in zip(cfgs, got):
            ref = jax_evaluate_compiled(jengine, cfg, TPU_V5E,
                                        recompute=recompute, reuse=True)
            ctx = (name, mode, cfg.describe(), recompute)
            _assert_sim_close(sim_b, ref.sim, ctx)
            _assert_mem_close(mem_b, ref.mem, ctx)


@pytest.mark.parametrize("sched", REPLAYABLE_SCHEDULES)
def test_batched_parity_schedules(sched):
    """Replayable pipeline schedules at pp=4: the planned-event replay
    loop must match the reference replay (to float64)."""
    vs = 2 if sched == "interleaved" else 1
    sc = (Scenario(GPT3_SMOKE).train(batch=8, seq=128)
          .parallel(dp=2, pp=4, microbatches=8)
          .schedule(sched, vstages=vs))
    jengine, bengine = _port(sc)
    got = bengine.evaluate_many([port_cfg(sc.cfg)], PORT_TPU_V5E)
    assert got[0] is not None
    ref = jax_evaluate_compiled(jengine, sc.cfg, TPU_V5E, reuse=True)
    _assert_sim_close(got[0][0], ref.sim, sched)
    _assert_mem_close(got[0][1], ref.mem, sched)


def test_zb_h1_falls_back():
    """zb-h1 is not batch-replayable: evaluate_many declines (None), and
    the sweep takes the per-config compiled path for it instead."""
    sc = (Scenario(GPT3_SMOKE).train(batch=8, seq=128)
          .parallel(dp=2, pp=4, microbatches=8).schedule("zb-h1"))
    _, bengine = _port(sc)
    cfg = port_cfg(sc.cfg)
    assert bengine.evaluate_many([cfg], PORT_TPU_V5E) == [None]
    assert not bengine.supports(cfg, PORT_TPU_V5E)
    engine, build, env, n_layers = port_engine(GPT3_SMOKE, "train", batch=8,
                                               seq=128)
    kw = dict(max_pp=4, microbatches=2, schedule=("zb-h1",), max_tp=1,
              max_cp=1, with_fsdp=False)
    got = dse.sweep(build, env, 8, PORT_TPU_V5E, n_layers=n_layers,
                    backend="batched", engine=engine, device="cpu", **kw)
    want = dse.sweep(build, env, 8, PORT_TPU_V5E, n_layers=n_layers,
                     engine=engine, **kw)
    assert [p.label for p in got] == [p.label for p in want]
    assert any(p.cfg.pp > 1 for p in got)
    for p, q in zip(got, want):
        if p.cfg.pp > 1:                            # the same compiled path
            assert p.sim.step_time == q.sim.step_time
        _assert_sim_close(p.sim, q.sim, p.label)
    assert got.batch_stats["points"] < len(got)


def test_batched_sweep_matches_reference_compiled():
    """Whole-sweep equivalence: the port's batched sweep against the JAX
    package's compiled sweep — same labels, same skip list, per-config
    results within the parity budget."""
    spec = get("qwen3-14b").smoke
    sc = Scenario(spec).train(batch=8, seq=64)
    kw = dict(microbatches=(1, 2), schedule=("1f1b", "gpipe"))
    ref = sc.sweep(8, **kw)
    engine, build, env, n_layers = port_engine(spec, "train", batch=8,
                                               seq=64)
    got = dse.sweep(build, env, 8, PORT_TPU_V5E, n_layers=n_layers,
                    name=spec.name, backend="batched", engine=engine,
                    device="cpu", **kw)
    assert len(ref) == len(got) > 0
    assert [s.reason for s in got.skipped] == [s.reason for s in ref.skipped]
    by_label = {p.label: p for p in got}
    assert set(by_label) == {p.label for p in ref}
    for p in ref:
        q = by_label[p.label]
        _assert_sim_close(q.sim, p.sim, p.label)
        _assert_mem_close(q.mem, p.mem, p.label)
    bs = got.batch_stats
    assert bs is not None and bs["points"] == len(got)
    assert "batched:" in got.summary()


def _sim_rel_err(backend, sc, jengine):
    sim_b, _ = backend.evaluate_many([port_cfg(sc.cfg)], PORT_TPU_V5E,
                                     recompute=True)[0]
    ref = jax_evaluate_compiled(jengine, sc.cfg, TPU_V5E, recompute=True,
                                reuse=True)
    return max(abs(getattr(ref.sim, a) - getattr(sim_b, a))
               / abs(getattr(ref.sim, a))
               for a in ("step_time", "compute_time", "comm_time"))


def test_float32_breaks_parity():
    """The 1e-6 budget needs float64: on a deep-pipeline 32-layer config
    the float32-forced backend accumulates past the budget while the
    float64 default stays well inside it."""
    spec = dataclasses.replace(GPT3_SMOKE, name="gpt3-l32", n_layers=32)
    sc = Scenario(spec).train(batch=32, seq=512).parallel(
        dp=2, tp=2, sp=True, pp=4, microbatches=16)
    jengine, f32 = _port(sc, dtype=torch.float32)
    f64 = BatchedBackend(f32.engine, device="cpu")
    assert f64.dtype is None
    assert _sim_rel_err(f32, sc, jengine) > REL
    assert _sim_rel_err(f64, sc, jengine) < REL / 100


def test_device_constants_in_the_backends_dtype():
    """Every floating constant of a class kernel is made once, in the
    backend's dtype, on its device — the busy-group rows included."""
    sc = _scenario(get("qwen3-14b").smoke, "train").parallel(
        dp=2, tp=2, sp=True, pp=2, microbatches=2)
    _, bengine = _port(sc)
    assert bengine.evaluate_many([port_cfg(sc.cfg)], PORT_TPU_V5E)[0]
    (kern,) = bengine._kernels.values()
    consts = [v for v in kern._c.values() if isinstance(v, torch.Tensor)]
    consts += [t for v in kern._c.values() if isinstance(v, tuple) for t in v]
    assert all(t.device.type == "cpu" for t in consts)
    assert all(t.dtype in (torch.float64, torch.int64, torch.bool)
               for t in consts)
    assert kern._c["m_busy"].dtype == torch.float64
    assert kern._c["m_busy"].shape == (2 * kern._G, kern._K)


def test_backend_without_device_needs_a_card(monkeypatch):
    """No device argument means the card; without one it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = port_engine(get("qwen3-14b").smoke, "train", batch=8,
                         seq=64)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedBackend(engine)
    engine, build, env, n_layers = port_engine(get("qwen3-14b").smoke,
                                               "train", batch=8, seq=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        dse.sweep(build, env, 8, PORT_TPU_V5E, n_layers=n_layers,
                  backend="batched", engine=engine)


@pytest.mark.parametrize("pp", [1, 2])
def test_one_busy_call_per_class_call(pp):
    """The compute and comm busy rows are one [2G, K] table: every slot in
    exactly one row (its group's compute row, or its comm row G further),
    one cost_reduce call per class call, and that call equal to the two
    separate calls on the halves of the table."""
    sc = _scenario(get("qwen3-14b").smoke, "train").parallel(
        dp=2, tp=2, sp=True, pp=pp, microbatches=2)
    _, bengine = _port(sc)
    calls = []
    real = cr.cost_reduce_bet

    def counting(x, w):
        calls.append(tuple(w.shape))
        return real(x, w)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cr, "cost_reduce_bet", counting)
        assert bengine.evaluate_many([port_cfg(sc.cfg)], PORT_TPU_V5E)[0]
    (kern,) = bengine._kernels.values()
    G, K = kern._G, kern._K
    m_busy = kern._c["m_busy"]
    assert calls == [(2 * G, K)]
    assert torch.equal(m_busy.sum(dim=0), torch.ones(K, dtype=torch.float64))
    dur = torch.from_numpy(np.random.RandomState(pp).uniform(
        0.0, 1e-3, (5, K)))
    both = cr.cost_reduce_bet(dur, m_busy)
    for half, rows in ((both[:, :G], m_busy[:G]), (both[:, G:], m_busy[G:])):
        np.testing.assert_allclose(half.numpy(),
                                   cr.cost_reduce_bet(dur, rows).numpy(),
                                   rtol=1e-15, atol=0.0)
