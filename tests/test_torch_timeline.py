"""The port's simulated-execution timelines (``repro_torch.obs.timeline``
through ``Trace.timeline`` / ``Job.timeline``) and the self-profiling
spans' Chrome trace (``Profile.chrome_trace``) against the JAX package's,
mirroring tests/test_timeline.py and the chrome-trace cases of
tests/test_obs.py on the CPU.

The Chrome-trace JSON must come out **byte for byte** as the reference
writes it (field order, float formatting, the ``"repro generator"``
process name), reconcile exactly with the simulated step time, and pass
the reference's own audit (``repro.analysis.check_timeline_file``) and the
port's (``repro_torch.analysis``) with equal reports on the files the port
wrote."""
import json

import pytest

import repro
import repro_torch
from repro.configs import ARCHS, get
from repro.obs.timeline import validate_chrome_trace as jax_validate
from repro_torch.obs import metrics, spans
from repro_torch.obs.timeline import validate_chrome_trace
from torch_port_helpers import both_packages, check_both

SCHEDULES = ("gpipe", "1f1b", "zb-h1", "interleaved")


def _trace(pkg, spec, mode, backend="compiled"):
    sc = pkg.Scenario(spec)
    sc = sc.train(batch=32, seq=2048) if mode == "train" \
        else sc.serve(batch=8, seq=512)
    return (sc.with_backend(backend)
            .parallel(pp=4, tp=2, microbatches=8).trace())


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("name", ARCHS)
def test_timeline_json_equal_and_exact(name, mode):
    """Every bundled arch, train and serve, all four schedules: the port's
    timeline tiles [0, step_time] float-exactly and its Chrome-trace JSON
    is the reference's."""
    trs = {pkg.__name__: _trace(pkg, spec, mode)
           for pkg, spec in both_packages(get(name).smoke)}
    for sched in SCHEDULES:
        tr = trs["repro_torch"]
        sim = tr.simulate(schedule=sched)
        tl = tr.timeline(schedule=sched)
        assert tl.reconcile(sim.step_time) == [], (name, mode, sched)
        assert tl.end_time == sim.step_time
        assert json.dumps(tl.chrome_trace()) == json.dumps(
            trs["repro"].timeline(schedule=sched).chrome_trace()), sched


@pytest.mark.parametrize("name", ARCHS[:2])
def test_reconcile_exact_sympy_backend(name):
    spec = both_packages(get(name).smoke)[1][1]
    tr = _trace(repro_torch, spec, "train", backend="sympy")
    for sched in SCHEDULES:
        assert tr.timeline(schedule=sched).reconcile(
            tr.simulate(schedule=sched).step_time) == []


def test_reconcile_detects_mismatch():
    spec = both_packages(get(ARCHS[0]).smoke)[1][1]
    tr = _trace(repro_torch, spec, "train")
    assert tr.timeline().reconcile(tr.simulate().step_time * 1.01) != []


@pytest.mark.parametrize("options", [dict(memory=True), dict(detail="all"),
                                     dict(detail="slots"),
                                     dict(schedule="zb-h1", memory=True)],
                         ids=["memory", "detail-all", "detail-slots",
                              "zb-h1-memory"])
def test_saved_file_byte_equal_and_audited(options, tmp_path):
    """``Trace.timeline(path)``: the same bytes as the reference's file,
    schema-valid, and clean under the reference's STG5xx audit."""
    for pkg, spec in both_packages(get(ARCHS[0]).smoke):
        _trace(pkg, spec, "train").timeline(
            str(tmp_path / f"{pkg.__name__}.json"), **options)
    got = (tmp_path / "repro_torch.json").read_bytes()
    assert got == (tmp_path / "repro.json").read_bytes()
    obj = json.loads(got)
    assert validate_chrome_trace(obj) == [] == jax_validate(obj)
    rep = check_both("check_timeline_file",
                     str(tmp_path / "repro_torch.json"))
    assert rep.ok, rep.render()


def test_utilization_equal():
    reps = {pkg.__name__: _trace(pkg, spec, "train").timeline().utilization()
            for pkg, spec in both_packages(get(ARCHS[0]).smoke)}
    got, want = reps["repro_torch"], reps["repro"]
    assert 0.0 < got.mfu < 1.0 and "MFU" in got.summary()
    assert got.summary() == want.summary()
    assert (got.mfu, got.bubble_fraction, got.exposed_comm_fraction) \
        == (want.mfu, want.bubble_fraction, want.exposed_comm_fraction)


def test_resilience_track_equal():
    """A failure/restore epoch track, sampled with the same string seed."""
    out = {}
    for pkg, spec in both_packages(get(ARCHS[0]).smoke):
        sc = (pkg.Scenario(spec).train(batch=32, seq=2048)
              .resilience(mtbf=300.0, seed=3))
        tr = sc.parallel(pp=4, tp=2, microbatches=8).trace()
        out[pkg.__name__] = tr.timeline(resilience=sc.resilience_spec,
                                        resilience_steps=2000).chrome_trace()
    obj = out["repro_torch"]
    assert any(e.get("cat") == "resilience" for e in obj["traceEvents"])
    assert json.dumps(obj) == json.dumps(out["repro"])
    assert check_both("check_timeline", obj).ok


def test_job_timeline_pool_lanes_equal(tmp_path):
    for pkg, spec in both_packages(get("minitron-8b").smoke):
        job = (pkg.Scenario(spec).generation(out_tokens=32, batch=8, seq=256)
               .disaggregate(prefill_pool=dict(tp=2), decode_pool=dict(tp=1),
                             kv_transfer=True))
        job.timeline(str(tmp_path / f"{pkg.__name__}.json"))
    got = (tmp_path / "repro_torch.json").read_bytes()
    assert got == (tmp_path / "repro.json").read_bytes()
    obj = json.loads(got)
    assert obj["otherData"]["kind"] == "serving-job"
    lanes = {e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"pool prefill", "pool decode", "pool kv-transfer"} <= lanes
    assert check_both("check_timeline_file",
                      str(tmp_path / "repro_torch.json")).ok


# ---- the self-profiling spans' Chrome trace (tests/test_obs.py) -------------

def test_chrome_trace_equals_reference():
    """``Profile.chrome_trace`` of the port's spans is what the reference's
    emitter makes of the same span records."""
    from repro.obs.timeline import profile_chrome_trace
    with spans.profiled() as prof:
        with spans.span("a", k=1):
            with spans.span("b"):
                pass
    obj = prof.chrome_trace()
    assert validate_chrome_trace(json.loads(json.dumps(obj))) == []
    assert {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"} \
        == {"a", "b"}
    assert json.dumps(obj) == json.dumps(profile_chrome_trace(prof.events))
    names = {e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"repro generator"}


def test_api_emits_spans_and_export(tmp_path):
    spec = both_packages(get(ARCHS[0]).smoke)[1][1]
    with spans.profiled() as prof:
        tr = (repro_torch.Scenario(spec).train(batch=32, seq=2048)
              .parallel(pp=2, tp=2, microbatches=4).trace())
        tr.simulate()
        tr.timeline()
    names = {e.name for e in prof.events}
    assert {"trace.instantiate", "trace.simulate", "trace.timeline"} <= names
    path = tmp_path / "prof.json"
    prof.export(str(path))
    assert validate_chrome_trace(json.loads(path.read_text())) == []


def test_snapshot_reports_cache_stats():
    snap = metrics.snapshot()
    assert "batched_stale_rewraps" in snap["caches"]
    assert set(snap["caches"]) == set(repro.compiled_cache_stats())


# ---- the observability CLI (tests/test_obs.py) -------------------------------

def test_obs_cli_summarize_diff_validate(tmp_path, capsys):
    """``python -m repro_torch.obs summarize | diff | validate`` on the
    port's snapshots and timeline: the exit codes and the output of the
    reference's CLI on the same files."""
    from repro.obs.__main__ import main as jax_main
    from repro_torch.obs.__main__ import main

    def both(argv, rc):
        assert main(argv) == rc
        got = capsys.readouterr().out
        assert jax_main(argv) == rc
        assert got == capsys.readouterr().out
        return got

    metrics.counter("cli.evt").inc(2)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(metrics.snapshot(caches=False)))
    metrics.counter("cli.evt").inc(5)
    b.write_text(json.dumps(metrics.snapshot(caches=False)))
    assert "counter.cli.evt" in both(["summarize", str(a)], 0)
    assert "+5" in both(["diff", str(a), str(b)], 0)

    tl = tmp_path / "tl.json"
    spec = both_packages(get(ARCHS[2]).smoke)[1][1]
    (repro_torch.Scenario(spec).train(batch=32, seq=2048)
     .parallel(pp=2, tp=2, microbatches=4).trace().timeline(str(tl)))
    assert "OK" in both(["validate", str(tl)], 0)
    bad = tmp_path / "bad.json"
    obj = json.loads(tl.read_text())
    for ev in obj["traceEvents"]:
        if ev["ph"] == "X":
            ev["dur"] = -1.0          # invalid duration
            break
    bad.write_text(json.dumps(obj))
    assert "STG501" in both(["validate", str(bad)], 1)
