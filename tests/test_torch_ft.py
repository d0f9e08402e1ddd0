"""The port's resilience modelling (``repro_torch.ft``: failure models and
their seeded traces, closed-form and replayed goodput, Young-Daly,
stragglers, elastic re-shard, and the sweeps' ``resilience=`` /
``rank_by="effective_goodput"``) against the JAX package's, mirroring
tests/test_resilience.py and the straggler half of
tests/test_ckpt_stragglers.py on the CPU.

The same pure-Python code with the same string seeds, so failure traces,
goodput scores and rankings must be **equal**; the batched backend
(``device="cpu"``) within rel 1e-6 of the compiled one, as the
reference's parity budget."""
import dataclasses
import math

import pytest

import repro
import repro.configs as configs
import repro_torch
from repro import Scenario, TPU_V5E
from repro.core.dse import DSEPoint, rank_points, score_resilience
from repro.ft import ResilienceSpec
from repro.ft import StragglerModel as JaxStragglerModel
from repro.ft import StragglerWatchdog as JaxStragglerWatchdog
from repro.ft import drive_watchdog as jax_drive_watchdog
from repro.ft import elastic_mesh_shape as jax_elastic_mesh_shape
from repro_torch import ft as pft
from repro_torch.core import dse as pdse
from repro_torch.core import topology as ptopo
from torch_port_helpers import (both_packages, check_both, dir_bytes, port_cfg,
                                run_both)

SMOKE = configs.get("granite-34b").smoke
MTBF = {"chip": 20e3, "nvlink": 40e3}


def _pod(pkg, n=2, **kw):
    mod = repro.core.topology if pkg is repro else ptopo
    return mod.h100_hgx_pod(n, **{"node_mtbf": 40e3, **kw})


def _slow(pkg):
    """The reference tests' deliberately slow checkpoint tier."""
    mod = repro.ft if pkg is repro else pft
    return mod.CkptTier("slow_fs", write_bw=1e4, read_bw=1e4,
                        restart_latency=30.0)


def _scenario(pkg, spec, **par):
    return (pkg.Scenario(spec).train(batch=16, seq=256).cluster(_pod(pkg))
            .parallel(**par))


# ---- failure model: the same traces by seed --------------------------------

@pytest.mark.parametrize("seed", [0, 3, "job-7"])
def test_failure_traces_equal_by_seed(seed):
    def sample(pkg, spec):
        m = pkg.ResilienceSpec(mtbf=MTBF).failure_model(_pod(pkg), 16)
        return ([dataclasses.astuple(d) for d in m.domains], m.rate,
                [dataclasses.astuple(e) for e in
                 m.sample(200 * m.system_mtbf, seed=seed).events])
    ref, port = run_both(SMOKE, sample)
    assert len(port[2]) > 100
    assert port == ref


def test_failure_model_errors_as_reference():
    for pkg, _ in both_packages(SMOKE):
        with pytest.raises(ValueError, match="unknown tiers"):
            pkg.ResilienceSpec(mtbf={"nope": 1e4}).failure_model(
                _pod(pkg), 16)
        with pytest.raises(ValueError, match="recovery"):
            pkg.ResilienceSpec(mtbf=1e4, recovery="magic")
    with pytest.raises(ValueError, match="mtbf"):
        ptopo.h100_hgx_pod(2, node_mtbf=-1.0)


# ---- goodput: closed form, replay, Young-Daly -----------------------------

@pytest.mark.parametrize("recovery", ["storage", "auto"])
@pytest.mark.parametrize("par", [dict(dp=2, tp=2, pp=2, microbatches=4,
                                      fsdp=True), dict(dp=8)],
                         ids=["mp", "dp"])
def test_score_point_and_replay_equal(par, recovery):
    def score(pkg, spec):
        sc = _scenario(pkg, spec, **par)
        tr = sc.trace()
        rs = pkg.ResilienceSpec(mtbf=MTBF, ckpt=_slow(pkg),
                                recovery=recovery)
        hw = sc._effective_hw(pkg.TPU_V5E)
        rep = tr.resilience_report(hw, spec=rs)
        model = rs.failure_model(_pod(pkg), sc.cfg.world)
        trace = model.sample(300 * model.system_mtbf, seed=rs.seed)
        mod = repro.ft if pkg is repro else pft
        out = [dataclasses.asdict(rep)]
        if not math.isinf(rep.interval):
            mc = mod.replay_goodput(trace, rep.interval, rep.ckpt_cost,
                                    rep.restore_cost)
            curve = mod.overhead_curve(trace, [f * rep.interval
                                               for f in (0.5, 1, 2)],
                                       rep.ckpt_cost, rep.restore_cost)
            out += [mc.goodput, [dataclasses.astuple(e) for e in mc.events],
                    curve, mod.young_daly_interval(rep.ckpt_cost,
                                                   rep.system_mtbf)]
        return out
    ref, port = run_both(SMOKE, score)
    assert 0 < port[0]["goodput"] <= 1
    assert port == ref


def test_goodput_closed_forms_equal():
    for f, args, kw in (
            ("expected_goodput", (100.0,), dict(rate=0.0, ckpt_cost_s=10.0,
                                                restore_cost_s=50.0)),
            ("expected_goodput", (30.0,), dict(rate=1e-3, ckpt_cost_s=2.0,
                                               restore_cost_s=9.0)),
            ("peer_goodput", (1e-4, 100.0), {}),
            ("young_daly_interval", (10.0, math.inf), {}),
            ("young_daly_interval", (3.0, 5e4), {})):
        assert getattr(pft, f)(*args, **kw) == \
            getattr(repro.ft, f)(*args, **kw), f
    with pytest.raises(ValueError):
        pft.expected_goodput(0.0, rate=1e-3, ckpt_cost_s=1.0,
                             restore_cost_s=1.0)
    with pytest.raises(ValueError):
        pft.ResilienceSpec(mtbf={})


# ---- stragglers -------------------------------------------------------------

def test_straggler_multipliers_equal():
    kw = dict(slow_fraction=0.3, slowdown=1.8, jitter=0.05, seed=3)
    jm, pm = JaxStragglerModel(**kw), pft.StragglerModel(**kw)
    assert pm.multipliers(64) == jm.multipliers(64)
    assert pm.host_multipliers(32, ranks_per_host=8) \
        == jm.host_multipliers(32, ranks_per_host=8)
    cfg = Scenario(SMOKE).parallel(dp=2, tp=2, pp=2, microbatches=4).cfg
    assert pm.stage_multipliers(port_cfg(cfg)) == jm.stage_multipliers(cfg)
    with pytest.raises(ValueError):
        pft.StragglerModel(slow_fraction=1.5)


def test_straggler_perturbed_simulate_equal():
    """A perturbed simulate on the compiled and sympy backends of each
    package: identical step times, in the port as in the reference."""
    def times(pkg, spec):
        sm = pkg.StragglerModel(slow_fraction=0.3, slowdown=1.8, seed=3)
        out = {}
        for backend in ("compiled", "sympy"):
            tr = (_scenario(pkg, spec, dp=2, tp=2, pp=2, microbatches=4)
                  .with_backend(backend).trace())
            base = tr.simulate()
            out[backend] = (base.step_time, tr.simulate(perturb=sm).step_time,
                            tr.simulate(perturb=(1.0, 1.0)).step_time)
        return out
    ref, port = run_both(SMOKE, times)
    assert port["compiled"] == port["sympy"]
    assert port["compiled"][1] > port["compiled"][0] == port["compiled"][2]
    assert port == ref
    tr = _scenario(repro_torch, both_packages(SMOKE)[1][1], tp=2, pp=2,
                   microbatches=4).trace()
    with pytest.raises(ValueError, match="pp"):
        tr.simulate(perturb=(1.0, 1.0, 1.0))


def _hosts(slow, n=4, mult=3.0):
    return {f"h{i}": (mult if f"h{i}" == slow else 1.0) for i in range(n)}


def test_watchdog_decisions_equal():
    """Evictions, strike decay and the driven watchdog: the same decisions
    step by step as the reference's."""
    def run(mod_wd, drive):
        wd = mod_wd(n_hosts=4, threshold=1.5, max_strikes=3,
                    strike_decay=0.5)
        seq = [wd.observe(1.0)]
        per = {h: m * 1.0 for h, m in _hosts("h0").items()}
        for t in (3.0, 1.0, 1.0, 3.0, 3.0, 3.0, 3.0):
            seq.append(wd.observe(t, per_host=per if t > 1 else None))
        seq.append(dict(wd.strikes))
        seq.append(wd.n_hosts)
        wd2 = mod_wd(n_hosts=4, threshold=1.5, max_strikes=2)
        seq += drive(wd2, healthy_step=1.0,
                     host_mults={"h0": 1.0, "h1": 2.5, "h2": 1.0,
                                 "h3": 1.0}, warmup=3, steps=10)
        return [dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d
                for d in seq]
    want = run(JaxStragglerWatchdog, jax_drive_watchdog)
    got = run(pft.StragglerWatchdog, pft.drive_watchdog)
    assert any(d.get("kind") == "evict" for d in got if isinstance(d, dict))
    assert got == want
    for world in (16, 32, 48, 100):
        assert pft.elastic_mesh_shape(world) == jax_elastic_mesh_shape(world)
    with pytest.raises(ValueError, match="cannot fit"):
        pft.elastic_mesh_shape(8)


# ---- elastic re-shard --------------------------------------------------------

@pytest.mark.parametrize("fsdp", [True, False])
def test_elastic_reshard_equal(fsdp):
    def plan(pkg, spec):
        sc = _scenario(pkg, spec, dp=4, tp=2, pp=2, microbatches=4,
                       fsdp=fsdp)
        mod = repro.ft if pkg is repro else pft
        p = mod.elastic_reshard(lambda: sc.builder().graph, sc.env(), sc.cfg,
                                k=8, hw=sc._effective_hw(pkg.TPU_V5E),
                                mem=sc.trace().memory())
        return (p.old_world, p.new_world, dataclasses.asdict(p.cfg),
                p.reshard_bytes, p.reshard_time)
    ref, port = run_both(SMOKE, plan)
    assert port[1] == 8 and (port[3] > 0) == fsdp
    assert port == ref
    with pytest.raises(ValueError):
        pft.shrink_cfg(_scenario(repro_torch, both_packages(SMOKE)[1][1],
                                 dp=4, tp=2).cfg, 8)


# ---- the sweeps: resilience= and rank_by="effective_goodput" -----------------

def _rows(points):
    return [(p.label, p.sim.step_time, p.mem.peak_bytes,
             dataclasses.asdict(p.resilience) if p.resilience else None,
             p.effective_step_time) for p in points]


def test_effective_goodput_flips_step_time_winner():
    """rank_points / score_resilience on hand-built points: the
    model-parallel config wins on step time, the replicated one once
    failures are priced in, in both packages alike."""
    def ranks(pkg, spec):
        hw = _scenario(pkg, spec, dp=16)._effective_hw(pkg.TPU_V5E)
        rs = pkg.ResilienceSpec(mtbf={"chip": 20e3}, ckpt=_slow(pkg))
        mod = repro.core.dse if pkg is repro else pdse
        pts = []
        for kw in (dict(tp=4, pp=4, microbatches=2), dict(dp=16)):
            sc = _scenario(pkg, spec, **kw)
            tr = sc.trace()
            pts.append(mod.DSEPoint(cfg=sc.cfg, sim=tr.simulate(hw),
                                    mem=tr.memory(), label=sc.cfg.describe()))
        mod.score_resilience(pts, rs, hw)
        mod.rank_points(pts, "step_time")
        first = pts[0].label
        mod.rank_points(pts, "effective_goodput")
        return first, _rows(pts)
    ref, port = run_both(SMOKE, ranks)
    assert port[0] != port[1][0][0]            # the ranking flipped
    assert port == ref
    with pytest.raises(ValueError):
        pdse.rank_points([], "tokens")


@pytest.mark.parametrize("backend", ["compiled", "batched"])
def test_sweep_rank_by_effective_goodput(backend):
    """Scenario.sweep with the scenario's resilience spec, ranked by
    effective goodput: the reference's points, scores and order (batched
    on the CPU within rel 1e-6 of the reference's compiled sweep)."""
    def sweep(pkg, spec):
        sc = (pkg.Scenario(spec).train(batch=8, seq=128).cluster(_pod(pkg))
              .resilience(mtbf={"chip": 20e3}, ckpt=_slow(pkg)))
        kw = dict(max_pp=2, rank_by="effective_goodput")
        if pkg is repro_torch:
            sc = sc.with_backend(backend)
            kw["device"] = "cpu"
        return sc.sweep(8, **kw)
    ref, port = run_both(SMOKE, sweep)
    assert port and all(p.resilience is not None for p in port)
    effs = [p.effective_step_time for p in port]
    assert effs == sorted(effs)
    assert "goodput" in port[0].row()
    assert [p.label for p in port] == [p.label for p in ref]
    if backend == "compiled":
        assert _rows(port) == _rows(ref)
    else:
        for p, q in zip(port, ref):
            assert p.sim.step_time == pytest.approx(q.sim.step_time, rel=1e-6)
            assert p.effective_step_time == pytest.approx(
                q.effective_step_time, rel=1e-6)
            assert p.resilience.recovery == q.resilience.recovery


def test_sweep_resilience_errors():
    spec = both_packages(SMOKE)[1][1]
    with pytest.raises(ValueError, match="rank_by"):
        repro_torch.Scenario(spec).train(batch=8, seq=128).sweep(
            8, rank_by="bogus")
    with pytest.raises(ValueError, match="resilience"):
        repro_torch.Scenario(spec).train(batch=8, seq=128).sweep(
            8, rank_by="effective_goodput")


def test_failure_free_sweep_is_bit_identical():
    """Scoring resilience does not move a point by a bit, as in the
    reference."""
    spec = both_packages(SMOKE)[1][1]
    base = (repro_torch.Scenario(spec).train(batch=8, seq=128)
            .cluster(_pod(repro_torch)))
    plain = base.sweep(8, max_pp=2)
    scored = base.resilience(mtbf=50e3).sweep(8, max_pp=2)
    assert [(p.label, p.sim.step_time, p.mem.peak_bytes) for p in plain] \
        == [(p.label, p.sim.step_time, p.mem.peak_bytes) for p in scored]


def test_serving_sweep_rank_by_effective_goodput():
    def sweep(pkg, spec):
        job = (pkg.Scenario(spec).cluster(_pod(pkg))
               .resilience(mtbf={"chip": 5e3}, ckpt="local_ssd")
               .prefill(batch=4, seq=256).generation(out_tokens=16))
        return [p.row() for p in job.sweep(8, max_pp=2,
                                           rank_by="effective_goodput")]
    ref, port = run_both(SMOKE, sweep)
    assert port and all("goodput" in r for r in port)
    effs = [r["eff_tokens_per_s"] for r in port]
    assert effs == sorted(effs, reverse=True)
    assert port == ref


def test_compiled_state_bytes_equal():
    from repro_torch.core import CompiledBackend, total_layers
    for kw in (dict(dp=2, tp=2, pp=2, microbatches=4, fsdp=True),
               dict(dp=4, pp=2, microbatches=2, zero1=True)):
        sc = _scenario(repro_torch, both_packages(SMOKE)[1][1], **kw)
        be = CompiledBackend(lambda: sc.builder().graph, sc.env(),
                             n_layers=total_layers(sc.spec))
        ref = _scenario(repro, SMOKE, **kw).trace().memory()
        assert be.state_bytes(sc.cfg) == pft.state_bytes(sc.trace().memory()) \
            == repro.ft.state_bytes(ref)


# ---- Chakra stamping: the reference's STG4xx checks on the port's files -----

def test_chakra_stamping_checked_by_reference(tmp_path):
    def export(pkg, spec):
        rs = pkg.ResilienceSpec(mtbf={"chip": 3e3, "nvlink": 5e3},
                                ckpt="local_ssd", recovery="storage")
        sc = (pkg.Scenario(spec).train(batch=8, seq=128).cluster(_pod(pkg))
              .resilience(rs).parallel(dp=2, tp=2, pp=2, microbatches=4))
        tr = sc.trace()
        out = tmp_path / pkg.__name__
        tr.export_chakra(str(out), resilience=True,
                         resilience_steps=20_000_000)
        rep, events = tr.resilience_events(steps=20_000_000)
        body = tr.chakra_stage(0, resilience=True,
                               resilience_steps=20_000_000)
        return (dataclasses.asdict(rep),
                [dataclasses.astuple(e) for e in events], body,
                dir_bytes(out))
    ref, port = run_both(SMOKE, export)
    assert port[1] and port == ref
    out = check_both("check_trace_dir", str(tmp_path / "repro_torch"))
    assert out.ok, out.render()


def test_unscored_points_refuse_effective_goodput():
    sc = Scenario(SMOKE).train(batch=8, seq=128).parallel(dp=2)
    tr = sc.trace()
    pts = [DSEPoint(cfg=sc.cfg, sim=tr.simulate(TPU_V5E), mem=tr.memory(),
                    label="x")]
    with pytest.raises(ValueError, match="resilience"):
        rank_points(pts, "effective_goodput")
    score_resilience(pts, ResilienceSpec(mtbf=1e4), TPU_V5E)
    psc = repro_torch.Scenario(both_packages(SMOKE)[1][1]).train(
        batch=8, seq=128).parallel(dp=2)
    ptr = psc.trace()
    ppts = [pdse.DSEPoint(cfg=psc.cfg, sim=ptr.simulate(), mem=ptr.memory(),
                          label="x")]
    with pytest.raises(ValueError, match="resilience"):
        pdse.rank_points(ppts, "effective_goodput")
    pdse.score_resilience(ppts, pft.ResilienceSpec(mtbf=1e4),
                          repro_torch.TPU_V5E)
    assert dataclasses.asdict(ppts[0].resilience) \
        == dataclasses.asdict(pts[0].resilience)
