"""The port's DSE search modes (``repro_torch.core.dse``: ``pareto_front``,
``branch_and_bound`` and ``sweep(search=...)``) against the JAX package's,
mirroring tests/test_dse_search.py on the CPU.

The port's sweeps here are built through ``build_graph`` / ``bind_env``
(``torch_port_helpers.port_engine``) for the same spec and workload the
reference's ``Scenario`` binds (the port's ``Scenario.sweep`` is held
against the reference's in tests/test_torch_api.py).  The headline
guarantee, as there: ``search="bnb"`` returns exactly the front that the
exhaustive sweep and ``pareto_front`` give, while fully evaluating under a
quarter of the space; here also exactly the reference's front on the same
spec (the compiled backends of the two packages agree bit for bit,
tests/test_torch_generator.py)."""
import random

import pytest

from repro import Scenario
from repro.configs import get
from repro.core.dse import pareto_front as jax_pareto_front
from repro_torch.core import TPU_V5E, dse
from torch_port_helpers import port_engine

SPACE = dict(microbatches=(1, 2, 4, 8), schedule=("1f1b", "gpipe"))
WORKLOAD = dict(batch=32, seq=64)


class _P:
    """Bare objective carrier quacking like a DSEPoint."""

    def __init__(self, step, peak, eff=None):
        self.step_ms = step
        self.peak_gb = peak
        self.effective_step_ms = eff if eff is not None else step


def _brute_front(pts):
    objs = [(p.step_ms, p.peak_gb, p.effective_step_ms) for p in pts]

    def dominated(i):
        return any(o != objs[i] and all(a <= b for a, b in zip(o, objs[i]))
                   for o in objs)
    return [p for i, p in enumerate(pts) if not dominated(i)]


# ---- pareto_front -----------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 8])
def test_pareto_front_brute_force(seed):
    rng = random.Random(seed)
    pts = [_P(rng.randint(1, 20), rng.randint(1, 20), rng.randint(1, 20))
           for _ in range(200)]
    got = dse.pareto_front(pts)
    assert [id(p) for p in got] == [id(p) for p in _brute_front(pts)]
    assert [id(p) for p in got] == [id(p) for p in jax_pareto_front(pts)]


def test_pareto_front_keeps_ties_and_order():
    a, b = _P(1.0, 5.0), _P(1.0, 5.0)        # exact tie: both kept
    c = _P(2.0, 4.0)                          # tradeoff: kept
    d = _P(2.0, 5.0)                          # dominated by a/b
    assert dse.pareto_front([d, c, b, a]) == [c, b, a]
    assert jax_pareto_front([d, c, b, a]) == [c, b, a]


def test_pareto_front_trivial():
    assert dse.pareto_front([]) == []
    p = _P(1.0, 1.0)
    assert dse.pareto_front([p]) == [p]


# ---- sweeps: the port's search modes against the reference's ---------------

@pytest.fixture(scope="module")
def port():
    """(engine, build, env, n_layers, spec name) of qwen3-14b's smoke spec
    in train mode, one compiled engine shared by the module's sweeps."""
    spec = get("qwen3-14b").smoke
    engine, build, env, n_layers = port_engine(spec, "train", **WORKLOAD)
    return engine, build, env, n_layers, spec.name


@pytest.fixture(scope="module")
def scenario():
    return Scenario(get("qwen3-14b").smoke).train(**WORKLOAD)


def _sweep(port, world, **kw):
    engine, build, env, n_layers, name = port
    return dse.sweep(build, env, world, TPU_V5E, n_layers=n_layers,
                     name=name, engine=engine, **kw)


def _labels(res):
    return sorted(p.cfg.describe() for p in res)


def _same_points(got, want):
    assert _labels(got) == _labels(want)
    for a, b in zip(sorted(got, key=lambda p: p.label),
                    sorted(want, key=lambda p: p.label)):
        assert a.label == b.label
        assert a.sim.step_time == b.sim.step_time
        assert a.mem.peak_bytes == b.mem.peak_bytes


def test_bnb_exact_front_with_pruning(port, scenario):
    """Pinned <= 2000-config space: bnb returns the exhaustive front
    exactly while fully evaluating < 25% of the feasible configs, and the
    same front as the reference's bnb and pareto sweeps."""
    full = _sweep(port, 16, search="pareto", **SPACE)
    bnb = _sweep(port, 16, search="bnb", **SPACE)
    assert len(full) > 0
    _same_points(bnb, full)
    assert bnb.total <= 2000
    assert bnb.visited < 0.25 * bnb.total, (bnb.visited, bnb.total)
    assert bnb.search == "bnb" and full.search == "pareto"
    assert "branch-and-bound" in bnb.summary()
    ref_bnb = scenario.sweep(16, search="bnb", **SPACE)
    _same_points(bnb, ref_bnb)
    assert (bnb.visited, bnb.total) == (ref_bnb.visited, ref_bnb.total)
    _same_points(full, scenario.sweep(16, search="pareto", **SPACE))


def test_bnb_front_is_the_brute_force_front(port):
    """The bnb front equals the brute-force front of every point of the
    full sweep (objectives step, peak memory, effective step)."""
    every = _sweep(port, 8, **SPACE)
    bnb = _sweep(port, 8, search="bnb", **SPACE)
    assert _labels(bnb) == sorted(p.cfg.describe()
                                  for p in _brute_front(list(every)))


def test_bnb_exact_front_all_schedules(port, scenario):
    """zb-h1 (no critical-path bound) and interleaved stay exact."""
    space = dict(microbatches=(2, 4, 8),
                 schedule=("1f1b", "gpipe", "interleaved", "zb-h1"))
    full = _sweep(port, 8, search="pareto", **space)
    bnb = _sweep(port, 8, search="bnb", **space)
    _same_points(bnb, full)
    assert bnb.visited < bnb.total
    _same_points(bnb, scenario.sweep(8, search="bnb", **space))


def test_pareto_search(port, scenario):
    """search="pareto" returns the front of the full evaluation with its
    accounting fields, as the reference's does."""
    full = _sweep(port, 8, **SPACE)
    front = _sweep(port, 8, search="pareto", **SPACE)
    assert front.evaluated == len(full)
    labels = {p.label for p in full}
    assert all(p.label in labels for p in front)
    assert 0 < len(front) <= len(full)
    assert "Pareto-front" in front.summary()
    ref = scenario.sweep(8, search="pareto", **SPACE)
    _same_points(front, ref)
    assert front.evaluated == ref.evaluated


def test_full_sweep_unchanged_shape(port):
    """Default search="full" returns every feasible point ranked by step
    time."""
    res = _sweep(port, 8, **SPACE)
    assert isinstance(res[0], dse.DSEPoint)
    steps = [p.sim.step_time for p in res]
    assert steps == sorted(steps)
    assert res.search == "full"


def test_bnb_rejects_sympy(port):
    with pytest.raises(ValueError, match="bnb"):
        _sweep(port, 8, search="bnb", backend="sympy", **SPACE)


def test_unknown_search_rejected(port):
    with pytest.raises(ValueError, match="search"):
        _sweep(port, 8, search="hillclimb", **SPACE)


def test_bnb_respects_mem_limit(port, scenario):
    """OOM labelling survives the bnb path, as in the reference."""
    res = _sweep(port, 16, search="bnb", mem_limit_gb=16.0, **SPACE)
    for p in res:
        assert ("(OOM)" in p.label) == (p.peak_gb > 16.0)
    ref = scenario.sweep(16, search="bnb", mem_limit_gb=16.0, **SPACE)
    assert sorted(p.label for p in res) == sorted(p.label for p in ref)


def test_bnb_resilience_not_ported(port, scenario):
    """Resilience scoring survives the bnb path (the ``ft`` slice is
    ported): every point scored, the same front and scores as the
    reference's."""
    from repro.ft import ResilienceSpec as JaxResilienceSpec
    from repro_torch.ft import ResilienceSpec
    res = _sweep(port, 16, search="bnb", mem_limit_gb=16.0,
                 resilience=ResilienceSpec(mtbf=30e3), **SPACE)
    assert res and all(p.resilience is not None for p in res)
    ref = scenario.sweep(16, search="bnb", mem_limit_gb=16.0,
                         resilience=JaxResilienceSpec(mtbf=30e3), **SPACE)
    assert [p.label for p in res] == [p.label for p in ref]
    assert [(p.step_ms, p.peak_gb, p.effective_step_ms) for p in res] \
        == [(p.step_ms, p.peak_gb, p.effective_step_ms) for p in ref]
