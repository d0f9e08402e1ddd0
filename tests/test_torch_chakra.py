"""The port's Chakra exporter (``repro_torch.core.chakra`` through
``repro_torch.api.Trace.export_chakra`` / ``chakra_stage``) against the JAX
package's, on the CPU.

Both are the same sympy + numpy code, so the per-rank files must be **byte
for byte** the reference's: dp / tp / pp meshes, microbatch-expanded
schedules, decomposed all-to-alls, a cluster topology's fabric attributes
and stamped failure/restore epochs.  The reference's own trace checks
(``repro.analysis.check_trace_dir``) and the port's
(``repro_torch.analysis``) run on the files the port wrote and give equal
reports."""
import json

import pytest

import repro
import repro_torch
from repro import ModelSpec
from repro.configs import get
from repro.core import MoESpec
from repro_torch.core import chakra as port_chakra
from torch_port_helpers import both_packages, check_both, dir_bytes, port_cfg

GPT = ModelSpec(name="gptish", n_layers=4, d_model=256, n_heads=8,
                n_kv_heads=4, d_ff=512, vocab=4096)
MOE = ModelSpec(name="moeish", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=4, d_ff=256, vocab=512, moe=MoESpec(8, 2, 2, 64))

CASES = {
    "dp-tp-pp": (GPT, dict(dp=2, tp=2, pp=2, microbatches=4), {}),
    "fsdp-zero1": (GPT, dict(dp=4, fsdp=True), {}),
    "expand-1f1b": (GPT, dict(dp=2, pp=2, microbatches=4),
                    dict(expand_microbatches=True)),
    "expand-gpipe": (GPT, dict(tp=2, pp=2, microbatches=2,
                               schedule="gpipe"),
                     dict(expand_microbatches=True)),
    "expand-interleaved": (GPT, dict(pp=2, microbatches=4,
                                     schedule="interleaved", vstages=2),
                           dict(expand_microbatches=True)),
    "expand-zb-h1": (GPT, dict(pp=2, microbatches=4, schedule="zb-h1"),
                     dict(expand_microbatches=True)),
    "moe-decompose-alltoall": (MOE, dict(dp=4, ep=True),
                               dict(decompose_alltoall=True)),
    "moe-alltoall": (MOE, dict(dp=2, tp=2, ep=True), {}),
}


def _export(pkg, spec, par, kw, out, topology=None):
    sc = pkg.Scenario(spec).train(batch=8, seq=64).parallel(**par)
    if topology is not None:
        sc = sc.cluster(topology(pkg))
    tr = sc.trace()
    return tr.export_chakra(str(out), **kw), tr


@pytest.mark.parametrize("case", list(CASES))
def test_export_chakra_byte_equal(case, tmp_path):
    """Every rank file and the manifest are the reference's bytes."""
    jspec, par, kw = CASES[case]
    files = {}
    for pkg, spec in both_packages(jspec):
        out = tmp_path / pkg.__name__
        n, tr = _export(pkg, spec, par, kw, out)
        assert n == tr.scenario.world
        files[pkg.__name__] = dir_bytes(out)
    assert len(files["repro_torch"]) == n + 1
    assert files["repro_torch"] == files["repro"]
    rep = check_both("check_trace_dir", str(tmp_path / "repro_torch"))
    assert rep.ok, rep.render()


def _pod(pkg):
    mod = repro.core.topology if pkg is repro \
        else repro_torch.core.topology
    return mod.h100_hgx_pod(2, node_mtbf=40e3)


def test_export_with_topology_byte_equal(tmp_path):
    """A cluster topology stamps algorithm / tier / pg_stride attrs on the
    comm nodes; the files are the reference's."""
    files = {}
    for pkg, spec in both_packages(GPT):
        out = tmp_path / pkg.__name__
        _export(pkg, spec, dict(dp=4, tp=2, pp=2, microbatches=4), {}, out,
                topology=_pod)
        files[pkg.__name__] = dir_bytes(out)
    body = json.loads(files["repro_torch"]["rank0.json"])
    assert any("tier" in nd["attrs"] for nd in body["nodes"]
               if nd["type"].startswith("COMM"))
    assert files["repro_torch"] == files["repro"]


def test_export_resilience_stamps_byte_equal(tmp_path):
    """Sampled failure/restore epochs (string-seeded, so the same events)
    are stamped into every rank body and counted in the manifest."""
    files = {}
    for pkg, spec in both_packages(get("granite-34b").smoke):
        rs = pkg.ResilienceSpec(mtbf={"chip": 3e3, "nvlink": 5e3},
                                ckpt="local_ssd", recovery="storage")
        sc = (pkg.Scenario(spec).train(batch=8, seq=128).cluster(_pod(pkg))
              .resilience(rs).parallel(dp=2, tp=2, pp=2, microbatches=4))
        out = tmp_path / pkg.__name__
        assert sc.trace().export_chakra(str(out), resilience=True,
                                        resilience_steps=20_000_000) == 8
        files[pkg.__name__] = dir_bytes(out)
    man = json.loads(files["repro_torch"]["manifest.json"])
    assert man["resilience"]["events"] > 0
    assert files["repro_torch"] == files["repro"]
    assert check_both("check_trace_dir", str(tmp_path / "repro_torch")).ok


def test_export_rank_subset_and_stale_files(tmp_path):
    """A subset of ranks, then the stale-file policy of a smaller re-export,
    as the reference handles them."""
    for pkg, spec in both_packages(GPT):
        sc = pkg.Scenario(spec).train(batch=8, seq=64).parallel(dp=4, tp=2)
        out = tmp_path / pkg.__name__
        assert sc.trace().export_chakra(str(out), ranks=[0, 5, 7]) == 3
        small = sc.parallel(dp=2, tp=2).trace()
        with pytest.raises(ValueError, match="on_stale"):
            small.export_chakra(str(out))
        assert small.export_chakra(str(out), on_stale="clean") == 4
    assert dir_bytes(tmp_path / "repro_torch") == dir_bytes(tmp_path / "repro")


@pytest.mark.parametrize("stage", [0, 1])
def test_chakra_stage_equal(stage):
    """The in-memory stage body, expanded and not, equals the reference's
    and passes its checks."""
    bodies = {}
    for pkg, spec in both_packages(GPT):
        tr = (pkg.Scenario(spec).train(batch=8, seq=64)
              .parallel(dp=2, tp=2, pp=2, microbatches=4).trace())
        bodies[pkg.__name__] = (tr.chakra_stage(stage),
                                tr.chakra_stage(stage,
                                                expand_microbatches=True))
    assert bodies["repro_torch"] == bodies["repro"]
    assert check_both("check_trace", bodies["repro_torch"][0],
                      rank=None).ok


def test_rank_coords_equal():
    """``rank_coords``, which the straggler model reads as well."""
    from repro.core.chakra import rank_coords
    sc = repro.Scenario(GPT).parallel(dp=2, tp=4, cp=2, pp=2,
                                      microbatches=4)
    cfg = sc.cfg
    for rank in range(cfg.world):
        assert port_chakra.rank_coords(rank, port_cfg(cfg)) \
            == rank_coords(rank, cfg)


def test_paper_scale_stage_equal():
    """qwen3-14b at its published widths over 32 768 GPUs (dp 512, tp 8,
    pp 8): stage 0's body is the reference's."""
    bodies = {}
    for pkg, spec in both_packages(get("qwen3-14b").spec):
        tr = (pkg.Scenario(spec).train(batch=4096, seq=4096)
              .parallel(dp=512, tp=8, pp=8).trace())
        assert tr.scenario.world == 32768
        bodies[pkg.__name__] = tr.chakra_stage(0)
    body = bodies["repro_torch"]
    assert len(body["nodes"]) > 100
    assert any(nd["type"].startswith("COMM") for nd in body["nodes"])
    assert body == bodies["repro"]
