"""The port's verifier (``repro_torch.analysis``: the rule registry, graph
lint, guard, schedule, comm and Chakra trace checks, and the front door's
``Trace.verify`` / ``Job.verify`` / ``sweep(verify=True)``) against the JAX
package's, mirroring tests/test_analysis.py on the CPU.

Same sympy + numpy code, so every report must be the reference's: compared
as lists of (code, severity, locus, message, fixit) with the package names
mapped (the port names itself where the reference's strings name ``repro``),
plus the per-pass tallies.  The seeded faults are applied to the port's own
exports (byte for byte the reference's, ``test_torch_chakra.py``), and both
packages' checks read the same faulty files."""
import dataclasses
import json
import os
import re
import shutil

import pytest

import repro
import repro.analysis as janalysis
import repro_torch
import repro_torch.analysis as analysis
from repro import ModelSpec
from repro.configs import ARCHS, get
from repro_torch.analysis.diagnostics import ERROR, INFO, SEVERITIES
from torch_port_helpers import (both_packages, check_both, port_spec,
                                report_rows as rows, run_both)

SPEC = ModelSpec(name="tiny-verify", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=2, d_ff=128, vocab=256)
PSPEC = port_spec(SPEC)


def _scenario(pkg=repro_torch, spec=PSPEC):
    return pkg.Scenario(spec).train(batch=8, seq=32)


def _export(pkg, spec, d):
    tr = _scenario(pkg, spec).parallel(dp=2, pp=2, microbatches=2).trace()
    tr.export_chakra(d, expand_microbatches=True)


@pytest.fixture(scope="module")
def clean_dir(tmp_path_factory):
    """One clean expanded pp=2 export of the port, shared by every fault
    test (the reference's export of the same config is its bytes)."""
    d = str(tmp_path_factory.mktemp("clean"))
    _export(repro_torch, PSPEC, d)
    ref = str(tmp_path_factory.mktemp("clean_ref"))
    _export(repro, SPEC, ref)
    for fn in os.listdir(ref):
        with open(os.path.join(ref, fn), "rb") as a, \
                open(os.path.join(d, fn), "rb") as b:
            assert a.read() == b.read(), fn
    return d


def _both_dir(d):
    """Both packages' ``check_trace_dir`` on one directory, equal."""
    return check_both("check_trace_dir", d)


def _mutated(clean_dir, tmp_path, fn, fname="rank1.json"):
    """Copy the port's clean export, apply ``fn`` to one rank's trace dict,
    and check the directory with both packages."""
    d = str(tmp_path)
    for f in os.listdir(clean_dir):
        shutil.copy(os.path.join(clean_dir, f), d)
    fp = os.path.join(d, fname)
    with open(fp) as f:
        t = json.load(f)
    fn(t)
    with open(fp, "w") as f:
        json.dump(t, f)
    return _both_dir(d)


# --------------------------------------------------------------------------
# diagnostics framework
# --------------------------------------------------------------------------

def test_rule_registry_is_consistent():
    """The same codes, severities and titles as the reference's registry."""
    assert len(analysis.RULES) >= 20
    assert SEVERITIES == janalysis.SEVERITIES
    for code, r in analysis.RULES.items():
        assert r.code == code and code.startswith("STG")
        assert r.severity in SEVERITIES
    assert {c: tuple(r) for c, r in analysis.RULES.items()} \
        == {c: tuple(r) for c, r in janalysis.RULES.items()}


def test_report_rejects_unregistered_code():
    for pkg in (analysis, janalysis):
        with pytest.raises(KeyError):
            pkg.Report().add("STG999", "no such rule")


def test_report_queries_and_render():
    texts = []
    for pkg in (analysis, janalysis):
        rep = pkg.Report(name="unit")
        assert rep.ok and "OK" in rep.render()
        rep.add("STG007", "just info")
        assert rep.ok and rep.codes() == {"STG007"}
        d = rep.add("STG301", "dup", node=7, rank=3, fixit="renumber")
        assert not rep.ok and d.severity == ERROR
        with pytest.raises(AssertionError):
            rep.raise_if_errors()
        texts.append((rep.render(), repr(rep)))
    assert texts[0] == texts[1]
    assert "STG301" in texts[0][0] and "rank3" in texts[0][0]


def test_report_extend_merges():
    a, b = analysis.Report(), analysis.Report()
    a.tally("x", 2)
    b.add("STG301", "dup")
    b.tally("x", 3)
    a.extend(b)
    assert a.checked["x"] == 5 and not a.ok
    ja, jb = janalysis.Report(), janalysis.Report()
    ja.tally("x", 2)
    jb.add("STG301", "dup")
    jb.tally("x", 3)
    assert rows(a) == rows(ja.extend(jb))


# --------------------------------------------------------------------------
# graph lint (STG0xx) on seeded faults, applied to each package's graph
# --------------------------------------------------------------------------

def _lint_both(fault=None, env=True):
    """Both packages lint their own graph of the tiny spec after
    ``fault(graph, package)``; the reports are equal."""
    def run(pkg, spec):
        sc = _scenario(pkg, spec)
        g = sc.builder().clone().graph
        if fault is not None:
            fault(g, pkg)
        an = analysis if pkg is repro_torch else janalysis
        e = sc.env() if env is True else env(pkg)
        return an.lint_graph(g, e) if e is not None else an.lint_graph(g)
    want, got = run_both(SPEC, run)
    assert _canonical(rows(got)) == _canonical(rows(want))
    return got


def _canonical(data: tuple) -> tuple:
    """Report rows with op ids and tensor uids (drawn from process-wide
    counters, so they depend on what the process built before) renumbered
    in the order they first appear."""
    seen: dict = {}

    def ident(n):
        return seen.setdefault(n, f"#{len(seen)}")
    diags, checked, name = data
    out = []
    for code, sev, rank, stage, phase, node, msg, fix in diags:
        node = ident(node) if isinstance(node, int) else node
        msg = re.sub(r"uid (\d+)", lambda m: f"uid {ident(int(m[1]))}", msg)
        out.append((code, sev, rank, stage, phase, node, msg, fix))
    return out, checked, name


def test_lint_clean_graph():
    rep = _lint_both()
    assert rep.ok and not rep.diagnostics
    assert rep.checked["graph_lint"] > 0


def test_dangling_tensor_detected():
    def fault(g, _pkg):
        consumed = {t.uid for op in g.ops for t in op.ins}
        g.ops.remove(next(op for op in g.ops
                          if any(t.uid in consumed for t in op.outs)))
    assert "STG001" in _lint_both(fault, env=lambda _pkg: None).codes()


def test_graph_cycle_detected():
    def fault(g, _pkg):
        prod = {t.uid: op for op in g.ops for t in op.outs}
        for op in g.ops:
            srcs = [prod[t.uid] for t in op.ins
                    if t.uid in prod and prod[t.uid] is not op]
            if srcs:
                srcs[0].ins.append(op.outs[0])
                break
    assert "STG003" in _lint_both(fault, env=lambda _pkg: None).codes()


def test_unbound_symbol_detected():
    """Nothing bound: the fixit names the port's ``bind_env``."""
    rep = _lint_both(env=lambda pkg: pkg.core.symbolic.Env())
    assert "STG004" in rep.codes()
    fix = rep.by_code("STG004")[0].fixit
    assert "repro_torch.core.assemble.bind_env" in fix


def test_einsum_dim_mismatch_detected():
    def fault(g, pkg):
        e = next(op for op in g.ops if isinstance(op, pkg.core.stg.Einsum)
                 and len(op.in_specs) >= 2)
        e.in_specs = [e.in_specs[0], e.in_specs[0]] + list(e.in_specs[2:])
    assert "STG005" in _lint_both(fault, env=lambda _pkg: None).codes()


def test_kv_cache_appends_are_not_dead_code():
    def run(pkg, spec):
        an = analysis if pkg is repro_torch else janalysis
        sc = pkg.Scenario(spec).decode(batch=4, kv_len=64)
        return rows(an.lint_graph(sc.builder().clone().graph))
    want, got = run_both(SPEC, run)
    assert got == want and not got[0]


# --------------------------------------------------------------------------
# guards: contradiction check, matcher behavior, structure-class splits
# --------------------------------------------------------------------------

def test_check_guards_contradiction():
    from repro_torch.core import ParallelCfg
    from repro_torch.core.distribute import guards_match
    guards = {(12, ("tp",)): True}
    for tp, ok in ((8, False), (4, True)):
        cfg = ParallelCfg(axes={"tp": tp}, tp_axis="tp")
        assert guards_match(guards, cfg) is ok
        rep = analysis.check_guards(guards, cfg)
        jrep = janalysis.check_guards(
            guards, repro.ParallelCfg(axes={"tp": tp}, tp_axis="tp"))
        assert rows(rep) == rows(jrep) and rep.ok is ok
        assert rep.codes() == (set() if ok else {"STG006"})


def test_structure_class_splits_on_guard_flip():
    from repro_torch.core import CompiledBackend, ParallelCfg, total_layers
    sc = _scenario()
    src = sc.builder()
    eng = CompiledBackend(lambda: src.clone().graph, sc.env(),
                          n_layers=total_layers(PSPEC))
    ca = ParallelCfg(axes={"tp": 2}, tp_axis="tp")
    cb = ParallelCfg(axes={"tp": 4}, tp_axis="tp")
    assert eng._structure_key(ca) == eng._structure_key(cb)
    pa, pb = eng.program(ca), eng.program(cb)
    assert eng.compiles == 2 and pa.guards != pb.guards
    assert pa.guards[(2, ("tp",))] is True
    assert pb.guards[(2, ("tp",))] is False
    eng.program(ca)
    assert eng.hits == 1 and eng.compiles == 2
    assert analysis.check_guards(pa.guards, ca).ok
    assert analysis.check_guards(pb.guards, cb).ok
    assert rows(analysis.check_guards(pa.guards, cb)) == rows(
        janalysis.check_guards(pa.guards, repro.ParallelCfg(
            axes={"tp": 4}, tp_axis="tp")))
    assert not analysis.check_guards(pa.guards, cb).ok


def test_decode_series_rejects_guard_flip_in_range():
    messages = []
    for pkg, spec in both_packages(SPEC):
        job = (pkg.Scenario(spec).prefill(batch=4, seq=32).parallel(cp=2)
               .generation(out_tokens=4))
        with pytest.raises(pkg.core.InfeasibleConfigError,
                           match="KV-dependent") as e:
            job.evaluate(pkg.TPU_V5E)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_decode_series_guard_stable_control():
    def run(pkg, spec):
        job = (pkg.Scenario(spec).prefill(batch=4, seq=32).parallel(tp=2)
               .generation(out_tokens=4))
        return job.evaluate(pkg.TPU_V5E).tokens_per_s
    want, got = run_both(SPEC, run)
    assert got == want > 0


# --------------------------------------------------------------------------
# schedule checks (STG2xx) on seeded faults
# --------------------------------------------------------------------------

def _schedule_both(name, pp, mb, v, fault=None) -> set:
    """Both packages check their own schedule after ``fault(timelines)``."""
    out = []
    for pkg, an in ((repro_torch, analysis), (repro, janalysis)):
        s = pkg.core.schedules.build_schedule(name, pp, mb, v)
        if fault is not None:
            tl = [list(t) for t in s.timelines]
            fault(tl)
            s = dataclasses.replace(
                s, timelines=tuple(tuple(t) for t in tl))
        out.append(an.check_schedule(s))
    assert rows(out[0]) == rows(out[1])
    return out[0]


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "interleaved", "zb-h1"])
def test_schedule_clean(name):
    rep = _schedule_both(name, 2, 4, 2)
    assert rep.ok and not rep.diagnostics


def test_schedule_missing_slot():
    def fault(tl):
        tl[1].pop(3)
    assert "STG204" in _schedule_both("1f1b", 2, 4, 1, fault).codes()


def test_schedule_deadlock_and_phase_order():
    def fault(tl):
        f0 = next(x for x in tl[0] if x.kind == "fwd" and x.mb == 0)
        tl[0].remove(f0)
        tl[0].append(f0)
    codes = _schedule_both("1f1b", 2, 4, 1, fault).codes()
    assert {"STG201", "STG202"} <= codes


def test_schedule_bwd_split_order():
    def fault(tl):
        stage = tl[1]
        i = next(i for i, sl in enumerate(stage) if sl.kind == "bwd_in")
        ref = stage[i]
        j = next(k for k, sl in enumerate(stage)
                 if sl.kind == "bwd_w" and sl.mb == ref.mb
                 and sl.vstage == ref.vstage)
        stage[i], stage[j] = stage[j], stage[i]
    assert "STG203" in _schedule_both("zb-h1", 2, 4, 1, fault).codes()


# --------------------------------------------------------------------------
# chakra trace checks (STG3xx) on seeded faults in the port's files
# --------------------------------------------------------------------------

def test_clean_export_verifies(clean_dir):
    rep = _both_dir(clean_dir)
    assert rep.ok and not rep.diagnostics, rep.render()
    assert rep.checked["trace_files"] == 4


def _drop_recv(t):
    i = next(i for i, n in enumerate(t["nodes"])
             if n["type"] == "COMM_RECV_NODE")
    del t["nodes"][i]


def _dup_id(t):
    t["nodes"][1]["id"] = t["nodes"][0]["id"]


def _cycle(t):
    t["nodes"][2]["ctrl_deps"] = [t["nodes"][-1]["id"]]


def _unresolved(t):
    t["nodes"][1]["data_deps"] = [99999999]


def _reorder_collectives(t):
    idx = [i for i, n in enumerate(t["nodes"])
           if n["type"] == "COMM_COLL_NODE"]
    i = idx[0]
    j = next(k for k in idx if t["nodes"][k]["name"] != t["nodes"][i]["name"])
    t["nodes"][i], t["nodes"][j] = t["nodes"][j], t["nodes"][i]


def _drop_mb1(t):
    i = next(i for i, n in enumerate(t["nodes"])
             if n.get("attrs", {}).get("mb") == 1)
    del t["nodes"][i]


def _bad_attr(t):
    n = next(n for n in t["nodes"] if n["type"] == "COMP_NODE")
    n["attrs"]["num_ops"] = "not-a-number"


FAULTS = {"dropped-recv": (_drop_recv, {"STG101"}, False),
          "duplicate-node-id": (_dup_id, {"STG301"}, False),
          "cyclic-ctrl-dep": (_cycle, {"STG303"}, False),
          "unresolved-dep": (_unresolved, {"STG302"}, True),
          "reordered-collective": (_reorder_collectives, {"STG307"}, True),
          "microbatch-expansion": (_drop_mb1, {"STG304"}, False),
          "attr-schema": (_bad_attr, {"STG306"}, True)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_seeded_trace_fault(fault, clean_dir, tmp_path):
    """The reference's seeded corruptions, each caught with its code (and,
    where the reference pins it, nothing else)."""
    fn, codes, only = FAULTS[fault]
    rep = _mutated(clean_dir, tmp_path, fn)
    assert (rep.codes() == codes) if only else (codes <= rep.codes())
    if fault == "reordered-collective":
        assert rep.by_code("STG307")[0].rank == 1


def test_stale_file_flagged(clean_dir, tmp_path):
    d = str(tmp_path)
    for f in os.listdir(clean_dir):
        shutil.copy(os.path.join(clean_dir, f), d)
    shutil.copy(os.path.join(d, "rank0.json"), os.path.join(d, "rank99.json"))
    rep = _both_dir(d)
    assert rep.codes() == {"STG308"}
    assert rep.by_code("STG308")[0].rank == 99


def test_manifest_missing_file_flagged(clean_dir, tmp_path):
    d = str(tmp_path)
    for f in os.listdir(clean_dir):
        shutil.copy(os.path.join(clean_dir, f), d)
    os.remove(os.path.join(d, "rank3.json"))
    rep = _both_dir(d)
    assert "STG308" in rep.codes()
    assert any("missing" in di.message for di in rep.by_code("STG308"))


def test_empty_dir(tmp_path):
    assert _both_dir(str(tmp_path)).codes() == {"STG309"}


# --------------------------------------------------------------------------
# disaggregated jobs: kv-transfer matching (STG305)
# --------------------------------------------------------------------------

def _disagg_job(pkg=repro_torch, spec=PSPEC):
    return (pkg.Scenario(spec).prefill(batch=4, seq=32)
            .generation(out_tokens=8)
            .disaggregate(prefill_pool=dict(tp=2), decode_pool=dict(dp=2),
                          kv_transfer=1e9))


@pytest.mark.parametrize("deep", [True, False])
def test_disaggregated_job_verifies_clean(deep):
    """``Job.verify`` gives the reference's report (deep: the job's Chakra
    export through ``check_trace_dir`` too)."""
    want, got = run_both(SPEC, lambda pkg, spec: rows(
        _disagg_job(pkg, spec).verify(deep=deep)))
    assert got == want and not got[0]
    assert ("trace_files" in got[1]) is deep


def test_orphan_kv_transfer(tmp_path):
    d = str(tmp_path)
    _disagg_job().export_chakra(d)
    assert _both_dir(d).ok
    for fn in sorted(os.listdir(d)):
        if not fn.startswith("rank"):
            continue
        fp = os.path.join(d, fn)
        with open(fp) as f:
            t = json.load(f)
        kv = [i for i, n in enumerate(t["nodes"])
              if n.get("attrs", {}).get("phase") == "kv_transfer"
              and n["type"] == "COMM_RECV_NODE"]
        if kv:
            del t["nodes"][kv[0]]
            with open(fp, "w") as f:
                json.dump(t, f)
            break
    else:
        pytest.fail("no kv-transfer recv found in the exported job")
    assert "STG305" in _both_dir(d).codes()


# --------------------------------------------------------------------------
# export manifest / on_stale semantics
# --------------------------------------------------------------------------

def test_manifest_written_and_complete(clean_dir):
    with open(os.path.join(clean_dir, "manifest.json")) as f:
        man = json.load(f)
    assert man["export"] == "ranks" and man["world"] == 4
    assert set(man["files"]) == {"rank0.json", "rank1.json", "rank2.json",
                                 "rank3.json", "manifest.json"}


def test_on_stale_error_clean_ignore(tmp_path):
    d = str(tmp_path)
    tr = _scenario().parallel(dp=2, pp=2, microbatches=2).trace()
    tr.export_chakra(d)
    stale = os.path.join(d, "rank7.json")
    shutil.copy(os.path.join(d, "rank0.json"), stale)
    with pytest.raises(ValueError, match="previous export"):
        tr.export_chakra(d)
    assert os.path.exists(stale)
    tr.export_chakra(d, on_stale="clean")
    assert not os.path.exists(stale)
    shutil.copy(os.path.join(d, "rank0.json"), stale)
    tr.export_chakra(d, on_stale="ignore")
    assert os.path.exists(stale)
    assert "STG308" in _both_dir(d).codes()
    with pytest.raises(ValueError, match="on_stale"):
        tr.export_chakra(d, on_stale="bogus")


def test_job_export_on_stale(tmp_path):
    d = str(tmp_path)
    job = _disagg_job()
    job.export_chakra(d)
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["export"] == "job"
    stale = os.path.join(d, "rank9.json")
    shutil.copy(os.path.join(d, "rank0.json"), stale)
    with pytest.raises(ValueError, match="previous export"):
        job.export_chakra(d)
    job.export_chakra(d, on_stale="clean")
    assert not os.path.exists(stale)
    assert _both_dir(d).ok


# --------------------------------------------------------------------------
# DSE: pool-split error type, prefilter, verify diagnostics
# --------------------------------------------------------------------------

def test_enumerate_pool_splits_raises_typed_error():
    from repro_torch.core.dse import enumerate_pool_splits
    from repro_torch.core.matcher import InfeasibleConfigError
    with pytest.raises(InfeasibleConfigError, match="world >= 2"):
        enumerate_pool_splits(1)
    assert enumerate_pool_splits(8) == [(1, 7), (2, 6), (4, 4)]


def _skips(res) -> list:
    return [(s.cfg.describe(), s.reason, s.prefiltered,
             rows(analysis.Report(diagnostics=list(s.diagnostics)))
             if s.diagnostics else None) for s in res.skipped]


@pytest.mark.parametrize("backend", ["compiled", "batched"])
def test_sweep_prefilters_infeasible_microbatching(backend):
    """``sweep(verify=True)``: the same points and the same skipped configs
    as the reference's, each with one STG007 info diagnostic."""
    kw = dict(device="cpu") if backend == "batched" else {}
    res = repro_torch.Scenario(PSPEC).train(batch=16, seq=32) \
        .with_backend(backend).sweep(4, microbatches=8, verify=True, **kw)
    want = repro.Scenario(SPEC).train(batch=16, seq=32).sweep(
        4, microbatches=8, verify=True)
    assert [p.label for p in res] == [p.label for p in want]
    assert len(res) > 0
    assert res.skipped and all(s.prefiltered for s in res.skipped)
    assert all(s.diagnostics and s.diagnostics[0].code == "STG007"
               for s in res.skipped)
    assert all(d.severity == INFO for s in res.skipped
               for d in s.diagnostics)
    assert _skips(res) == [
        (s.cfg.describe(), s.reason, s.prefiltered,
         rows(janalysis.Report(diagnostics=list(s.diagnostics))))
        for s in want.skipped]
    assert res.pruned == want.pruned
    assert sum(res.pruned.values()) == len(res.skipped)
    assert "feasible" in res.summary() and "skipped" in res.summary()


def test_sweep_without_verify_has_no_diagnostics():
    res = repro_torch.Scenario(PSPEC).train(batch=16, seq=32).sweep(
        4, microbatches=8)
    assert res.skipped and all(not s.diagnostics for s in res.skipped)


# --------------------------------------------------------------------------
# the clean matrix: every bundled arch x mode x schedule verifies clean
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_bundled_arch_verifies_clean(name):
    """Every arch's smoke spec, from the port's own ``configs``: train and
    decode under each schedule verify clean, and the port's reports equal
    the reference's (tallies included)."""
    from repro_torch.configs import get as port_get
    spec, jspec = port_get(name).smoke, get(name).smoke
    for sched in ("gpipe", "1f1b", "interleaved", "zb-h1"):
        for mode in ("train", "decode"):
            got, want = (
                rows((pkg.Scenario(s).train(batch=4, seq=32)
                      if mode == "train" else
                      pkg.Scenario(s).decode(batch=4, kv_len=64))
                     .parallel(dp=2, pp=2, microbatches=2, schedule=sched)
                     .trace().verify(include_graph=True))
                for pkg, s in ((repro_torch, spec), (repro, jspec)))
            assert got == want, f"{name}/{mode}/{sched}"
            assert not got[0], f"{name}/{mode}/{sched}: {got[0]}"


def test_trace_verify_chakra_mode():
    want, got = run_both(SPEC, lambda pkg, spec: rows(
        _scenario(pkg, spec).parallel(dp=2, pp=2, microbatches=2).trace()
        .verify(chakra=True)))
    assert got == want and not got[0]
    assert got[1].get("trace_nodes", 0) > 0


def test_verify_workload_and_graph_equal_reference():
    """``verify_workload`` / ``verify_graph``, the package-level helpers the
    front door builds on, give the reference's reports."""
    def run(pkg, spec):
        an = analysis if pkg is repro_torch else janalysis
        tr = _scenario(pkg, spec).parallel(tp=2, pp=2, microbatches=2) \
            .trace()
        cfg = tr.scenario.cfg
        return (rows(an.verify_workload(tr.workload, graph=tr.graph,
                                        env=tr.env)),
                rows(an.verify_graph(tr.graph, tr.env,
                                     guards={(3, ("tp",)): True}, cfg=cfg)))
    want, got = run_both(SPEC, run)
    assert got == want
    assert not got[0][0] and {d[0] for d in got[1][0]} == {"STG006"}
