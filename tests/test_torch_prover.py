"""The port's symbolic invariant prover (``repro_torch.analysis.prover``:
``prove_space``, ``Scenario.prove``, ``sweep(prove=True)``, the
certificate-driven bnb pruning, SARIF and the ``python -m
repro_torch.analysis`` CLI) against the JAX package's, mirroring
tests/test_prover.py on the CPU.

Same sympy + numpy code, so every certificate must be the reference's:
per-class verdicts, lattice points, summaries and reports (package names
mapped).  The seeded corruptions are applied to the **port's** engines and
modules (and, for the comparison, the same ones to the reference's)."""
import importlib
import json

import pytest

import repro
import repro.analysis as janalysis
import repro_torch
import repro_torch.analysis as analysis
from repro.configs import ARCHS, get
from repro_torch.configs import get as port_get
from torch_port_helpers import report_rows as rows

WORLD = 8
SPACE = dict(microbatches=(1, 2, 4, 8), schedule=("1f1b", "gpipe"))
PACKAGES = {"port": (repro_torch, analysis), "reference": (repro, janalysis)}


def cert_data(cert) -> tuple:
    """Everything a SpaceCertificate states, as plain data."""
    return (cert.name, cert.summary(), cert.ok, cert.partition_ok,
            cert.configs, cert.lattice_points, cert.inflight_monotone,
            [(c.label, c.axes, c.degrees, c.flop_conserved,
              c.comm_conserved, c.guards_faithful, c.bound_sound,
              c.mem_monotone) for c in cert.classes], rows(cert.report))


def _scenario(pkg, arch="qwen3-14b", mode="train"):
    spec = (port_get if pkg is repro_torch else get)(arch).smoke
    if mode == "train":
        return pkg.Scenario(spec).train(batch=32, seq=64)
    return pkg.Scenario(spec).decode(batch=4, kv_len=64)


def _fresh_engine(pkg, sc):
    """A private engine (not the process-wide cache) that corruption tests
    may mutate freely."""
    src = sc.builder()
    return pkg.core.CompiledBackend(lambda: src.clone().graph, sc.env(),
                                    n_layers=pkg.core.total_layers(sc.spec))


# ---- clean spaces certify ---------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_all_archs_certify_clean(arch, mode):
    """Every arch from the port's own ``configs``, both modes, at world 8:
    clean, and the certificate the reference's."""
    cert = _scenario(repro_torch, arch, mode).prove(WORLD)
    assert cert.ok, cert.report.render()
    assert not cert.report.diagnostics
    assert cert.partition_ok and cert.inflight_monotone
    assert cert.classes and all(c.ok for c in cert.classes)
    assert cert.lattice_points > 0
    assert "all invariants certified" in cert.summary()
    assert cert_data(cert) == cert_data(_scenario(repro, arch, mode)
                                        .prove(WORLD))


def test_certificate_covers_every_config_of_the_space():
    datas = []
    for pkg, an in PACKAGES.values():
        cfgs = list(pkg.core.dse.enumerate_configs(16, **SPACE))
        cert = an.prove_space(_fresh_engine(pkg, _scenario(pkg)), cfgs=cfgs)
        assert cert.ok
        assert cert.configs == len(cfgs) == 340
        assert cert.lattice_points < len(cfgs) / 4
        assert cert.memory_monotone_programs()
        datas.append(cert_data(cert))
    assert datas[0] == datas[1]


# ---- seeded violations ------------------------------------------------------


def _guarded_prog(engine):
    for progs in engine.classes().values():
        for prog in progs:
            if prog.guards:
                return prog
    raise AssertionError("no guarded structure class compiled")


def _guard_deletion(engine, _pkg):
    prog = _guarded_prog(engine)
    prog.guards.pop(next(iter(prog.guards)))


def _guard_duplication(engine, _pkg):
    prog = _guarded_prog(engine)
    (_val, axes), _ok = next(iter(prog.guards.items()))
    prog.guards[(0, axes)] = True       # 0 % deg == 0 for every deg


def _class_duplication(engine, _pkg):
    for key, progs in engine._classes.items():
        for prog in progs:
            if prog.guards:
                engine._classes[key].append(prog)
                return
    raise AssertionError("no guarded structure class compiled")


def _flop_corruption(engine, _pkg):
    for progs in engine.classes().values():
        for prog in progs:
            for p in prog.nodes:
                if p.flop and p.flop[0] == "scale":
                    t = p.flop[2]
                    if prog._t_part[t]:
                        a, _k = prog._t_part[t][0]
                        prog._t_part[t] = ((a, 2),)
                        return
    raise AssertionError("no sharded scale-flop tensor found")


def _memory_corruption(engine, _pkg):
    for progs in engine.classes().values():
        for prog in progs:
            for t, pat in enumerate(prog._t_part):
                if pat:
                    a, _k = pat[0]
                    prog._t_part[t] = ((a, -1),)
                    return
    raise AssertionError("no partitioned tensor found")


def _bad_wire(coll, size, n):
    return size * (n - 1) / n, n - 1          # AllReduce lost a phase


def _inflated_floor(real):
    def inflated(prog, cfg, hw, recompute, comm_ok):
        m, path, o = real(prog, cfg, hw, recompute, comm_ok)
        return m * 2 + 1e-6, path, o
    return inflated


def _unsound_bound(_real):
    def unsound(cfg, floor):
        m, path, o = floor
        return max(cfg.microbatches * m, path) + o
    return unsound


# name -> (engine corruption | (module, attribute, replacement factory),
#          the code the prover must report)
CORRUPTIONS = {
    "guard-deletion": (_guard_deletion, "STG604"),
    "guard-duplication": (_guard_duplication, "STG604"),
    "class-duplication": (_class_duplication, "STG603"),
    "flop-corruption": (_flop_corruption, "STG601"),
    "memory-corruption": (_memory_corruption, "STG606"),
    "comm-corruption": (("compiled", "collective_wire", lambda _r: _bad_wire),
                        "STG602"),
    "unsound-floor": (("dse", "_cell_floor", _inflated_floor), "STG605"),
    "zbh1-bound-misuse": (("dse", "step_lower_bound", _unsound_bound),
                          "STG605"),
}


def _prove_corrupted(pkg, an, corruption, monkeypatch):
    """Certify clean, apply the corruption, re-prove: the second
    certificate.  A module patch replaces the attribute on the package's
    own module and re-proves without retracing, as the reference does."""
    engine = _fresh_engine(pkg, _scenario(pkg))
    cfgs = list(pkg.core.dse.enumerate_configs(WORLD))
    clean = an.prove_space(engine, cfgs=cfgs)
    assert clean.ok, clean.report.render()
    if callable(corruption):
        corruption(engine, pkg)
        return an.prove_space(engine, cfgs=cfgs)
    mod_name, attr, factory = corruption
    mod = getattr(pkg.core, mod_name)
    monkeypatch.setattr(mod, attr, factory(getattr(mod, attr)))
    return an.prove_space(engine, cfgs=cfgs, retrace=False)


@pytest.mark.parametrize("name", list(CORRUPTIONS))
def test_seeded_corruption(name, monkeypatch):
    """Each of the reference's seeded corruptions, applied to the port's
    engine or module, is caught with the reference's code, and the port's
    certificate is the reference's under the same corruption."""
    corruption, code = CORRUPTIONS[name]
    got = _prove_corrupted(repro_torch, analysis, corruption, monkeypatch)
    assert not got.ok
    assert code in got.report.codes()
    if code == "STG603":
        assert not got.partition_ok
    if code == "STG606":
        assert not got.memory_monotone_programs() or any(
            not c.mem_monotone for c in got.classes)
    want = _prove_corrupted(repro, janalysis, corruption, monkeypatch)
    assert cert_data(got) == cert_data(want)


def test_seeded_guard_flip():
    """A recorded predicate flipped so the class widens onto a point another
    class owns breaks disjointness (STG603), in the port as in the
    reference."""
    datas = []
    for pkg, an in PACKAGES.values():
        engine = _fresh_engine(pkg, _scenario(pkg))
        cfgs = list(pkg.core.dse.enumerate_configs(WORLD))
        assert an.prove_space(engine, cfgs=cfgs).ok
        lattice: dict = {}
        for cfg in cfgs:
            key = pkg.core.CompiledBackend._structure_key(cfg)
            lattice.setdefault(key, set()).add(
                tuple(cfg.axes.get(a, 1) for a in key[0]))
        cert = _flip_one_guard(pkg, an, engine, cfgs, lattice)
        assert not cert.ok and not cert.partition_ok
        assert "STG603" in cert.report.codes()
        datas.append(cert_data(cert))
    assert datas[0] == datas[1]


def _flip_one_guard(pkg, an, engine, cfgs, lattice):
    match = importlib.import_module(
        f"{pkg.__name__}.core.distribute").guards_match_degrees
    for key, progs in engine.classes().items():
        pts = [dict(zip(key[0], d)) for d in lattice.get(key, ())]
        for prog in progs:
            for gk, ok in prog.guards.items():
                trial = dict(prog.guards)
                trial[gk] = not ok
                if any(match(trial, p) for p in pts):
                    prog.guards[gk] = not ok      # widen onto an owned point
                    return an.prove_space(engine, cfgs=cfgs)
    raise AssertionError("no widening guard flip available in this space")


# ---- certificate-driven pruning ---------------------------------------------


def _front(res) -> tuple:
    return ([p.cfg.describe() for p in res], [p.sim.step_time for p in res],
            res.visited, res.total)


@pytest.mark.parametrize("backend", ["compiled", "batched"])
def test_bnb_prove_front_and_visited_identical(backend):
    """bnb with the certificates returns the front and the visit count of
    bnb without them, the reference's on the compiled backend (the batched
    one on the CPU within rel 1e-6 of it)."""
    kw = dict(device="cpu") if backend == "batched" else {}
    sc = _scenario(repro_torch).with_backend(backend)
    plain = sc.sweep(16, search="bnb", **SPACE, **kw)
    proved = sc.sweep(16, search="bnb", prove=True, **SPACE, **kw)
    assert proved.certificates is not None and proved.certificates.ok
    assert proved.visited == plain.visited
    assert proved.total == plain.total == 328
    assert _front(plain)[0] == _front(proved)[0]
    assert [p.sim.step_time for p in plain] \
        == [p.sim.step_time for p in proved]
    assert "proved:" in proved.summary()
    jsc = _scenario(repro)
    want = jsc.sweep(16, search="bnb", prove=True, **SPACE)
    assert cert_data(proved.certificates) == cert_data(want.certificates)
    got, ref = _front(proved), _front(want)
    assert got[0] == ref[0] and got[2:] == ref[2:]
    if backend == "compiled":
        assert got[1] == ref[1]
    else:
        assert all(abs(a - b) <= 1e-6 * b for a, b in zip(got[1], ref[1]))


def test_bnb_certificate_skips_memory_evaluations():
    from repro_torch.obs import metrics
    before = metrics.counter("dse.bnb_cert_pruned").value
    _scenario(repro_torch).sweep(16, search="bnb", prove=True, **SPACE)
    assert metrics.counter("dse.bnb_cert_pruned").value > before


@pytest.mark.parametrize("backend", ["compiled", "batched"])
def test_sweep_full_attaches_certificates(backend):
    """``sweep(prove=True)`` attaches the reference's certificate and ranks
    the reference's points (the batched backend proves the compiled engine
    it wraps)."""
    kw = dict(device="cpu") if backend == "batched" else {}
    res = _scenario(repro_torch).with_backend(backend).sweep(
        WORLD, search="full", prove=True, **kw)
    assert res.certificates is not None
    assert res.certificates.ok
    assert "proved:" in res.summary()
    want = _scenario(repro).sweep(WORLD, search="full", prove=True)
    assert cert_data(res.certificates) == cert_data(want.certificates)
    assert [p.label for p in res] == [p.label for p in want]


# ---- SweepResult.summary() robustness ---------------------------------------


def test_summary_no_division_by_zero_at_empty_total():
    texts = [pkg.core.dse.SweepResult([], [], backend="compiled",
                                      search="bnb", evaluated=0, visited=0,
                                      total=0).summary()
             for pkg, _ in PACKAGES.values()]
    assert "n/a" in texts[0] and texts[0] == texts[1]


def test_summary_engine_hit_ratio_na_when_no_lookups():
    texts = [pkg.core.dse.SweepResult(
        [], [], backend="compiled",
        engine_stats={"classes": 0, "compiles": 0, "hits": 0}).summary()
        for pkg, _ in PACKAGES.values()]
    assert "n/a hit ratio" in texts[0] and texts[0] == texts[1]


# ---- SARIF export -----------------------------------------------------------


def _unit_report(an):
    rep = an.Report(name="unit")
    rep.add("STG601", "flops differ", node="mlp_up")
    rep.add("STG007", "infeasible", phase="fwd")
    return rep


def test_sarif_structure_and_rule_metadata():
    """The port's SARIF names the port by default; with the same
    ``tool_name`` it is the reference's document."""
    doc = analysis.to_sarif([_unit_report(analysis)])
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "repro_torch.analysis"
    rules = {r["id"]: r for r in run["tool"]["driver"]["rules"]}
    assert "STG601" in rules and "STG606" in rules
    assert rules["STG601"]["defaultConfiguration"]["level"] == "error"
    results = run["results"]
    assert len(results) == 2
    assert results[0]["ruleId"] == "STG601"
    assert results[0]["level"] == "error"
    assert results[1]["level"] == "note"
    loc = results[0]["locations"][0]["logicalLocations"][0]
    assert "mlp_up" in loc["fullyQualifiedName"]
    assert analysis.to_sarif([_unit_report(analysis)],
                             tool_name="repro.analysis") \
        == janalysis.to_sarif([_unit_report(janalysis)])


def _sarif_by_cli(pkg, args, out) -> dict:
    main = __import__(f"{pkg.__name__}.analysis.__main__",
                      fromlist=["main"]).main
    assert main([*args, "--sarif", str(out)]) == 0
    doc = json.loads(out.read_text())
    doc["runs"][0]["tool"]["driver"]["name"] = "*"
    return doc


def test_sarif_cli_writes_file(tmp_path, capsys):
    """``python -m repro_torch.analysis <timeline> --timeline --sarif``:
    exit 0 and the reference's SARIF (its tool name aside), on the port's
    timeline file."""
    tl = tmp_path / "tl.json"
    _scenario(repro_torch).parallel(dp=2).trace().timeline(str(tl))
    got = _sarif_by_cli(repro_torch, [str(tl), "--timeline"],
                        tmp_path / "out.sarif")
    assert got["runs"][0]["tool"]["driver"]["rules"]
    want = _sarif_by_cli(repro, [str(tl), "--timeline"],
                         tmp_path / "ref.sarif")
    assert got == want
    out = capsys.readouterr().out
    assert "sarif: 1 report(s)" in out


def test_cli_configs_equal_reference(tmp_path, capsys):
    """``--configs``: every arch's smoke spec linted in train and decode,
    from the port's own configs, with the reference's reports and SARIF."""
    from repro.analysis import __main__ as jcli
    from repro_torch.analysis import __main__ as cli
    got, want = [], []
    assert cli._verify_configs(False, got) == 0
    assert jcli._verify_configs(False, want) == 0
    assert len(got) == 2 * len(ARCHS)
    assert [rows(r) for r in got] == [rows(r) for r in want]
    assert _sarif_by_cli(repro_torch, ["--configs"], tmp_path / "a.sarif") \
        == _sarif_by_cli(repro, ["--configs"], tmp_path / "b.sarif")
    capsys.readouterr()


def test_cli_prove_equal_reference(tmp_path, monkeypatch, capsys):
    """``--prove --world 8`` over two archs (the port's ``ARCHS`` and the
    reference's cut to the same two; every arch is proved by
    ``test_all_archs_certify_clean``): exit 0, the reference's lines."""
    two = ("qwen3-14b", "deepseek-v2-236b")
    monkeypatch.setattr(repro_torch.configs, "ARCHS", two)
    monkeypatch.setattr(repro.configs, "ARCHS", two)
    outs = []
    for pkg, name in ((repro_torch, "a"), (repro, "b")):
        doc = _sarif_by_cli(pkg, ["--prove", "--world", "8"],
                            tmp_path / f"{name}.sarif")
        outs.append((doc, capsys.readouterr().out.splitlines()))
    assert outs[0][0] == outs[1][0] and not outs[0][0]["runs"][0]["results"]
    prove_lines = [[ln for ln in o if ln.startswith("prove ")] for _, o in outs]
    assert len(prove_lines[0]) == 4 and prove_lines[0] == prove_lines[1]
    assert all("all invariants certified" in ln for ln in prove_lines[0])
