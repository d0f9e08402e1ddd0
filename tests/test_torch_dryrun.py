"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, at published size, nothing run: for the ten archs on the fake
256-rank (16x16) and 512-rank (2x16x16) process groups, the logical rules,
the batch's shapes, dtypes and specs, the decode caches' specs (the
layer-sharding heuristic and the batch one), rank 0's argument bytes (the
port's fake local shards against ``NamedSharding.shard_shape``),
``model_flops_total`` and (training and decode) ``stage_predict`` on H100s
are equal.  The JAX
package's values come from one subprocess (``tests/torch_dryrun_reference.py``:
``repro.launch.dryrun`` pins ``XLA_FLAGS`` for 512 devices at import, which
must not leak into this worker), started first and read last.  Also the
counter, the records, resuming, and the runtime's field names."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.models.common import RuntimeCfg as JaxRuntimeCfg
from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.core.costmodel import H100_HGX
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import RuntimeCfg

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("16x16", "2x16x16")
CELLS = [(m, a) for m in MESHES for a in ARCHS]
# stage_predict is compared at these (a Scenario trace takes a second or two)
STAGE_SHAPES = ("train_4k", "decode_32k")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A getter of the JAX package's values: the subprocess starts here and
    is read when a test first asks."""
    out = tmp_path_factory.mktemp("dryrun_reference") / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_reference.py"),
         str(out)], env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    got: dict = {}

    def read() -> dict:
        if not got:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            got.update(json.loads(out.read_text()))
        return got
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _entry(e):
    if e is None:
        return None
    return list(e) if isinstance(e, (tuple, list)) else [e]


def _spec(sharding) -> list:
    """A spec as the reference file writes a PartitionSpec."""
    return [_entry(e) for e in sharding.spec]


def _paths(tree, prefix=""):
    """(path, leaf) of nested dicts and lists, the reference's path form."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.fixture(scope="module")
def port(reference):
    """The port's values in the reference file's layout, on the fake groups
    (``device="cpu"``), each destroyed after use."""
    out: dict = {}
    for multi_pod in (False, True):
        tag = "2x16x16" if multi_pod else "16x16"
        with dryrun.fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            da = dryrun.data_axes_of(mesh)
            for name in ARCHS:
                arch = get(name)
                rules = dryrun.arch_rules(arch, mesh)
                rec = out.setdefault(tag, {})[name] = {
                    "rules": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in rules.items()},
                    "fsdp": rules.get("embed") == da, "shapes": {}}
                for shape_name, shape in SHAPES.items():
                    sds, shd = dryrun.batch_specs(arch, shape, mesh)
                    cell = rec["shapes"][shape_name] = {
                        "batch": {k: {"shape": list(sds[k].shape),
                                      "dtype": str(sds[k].dtype).replace(
                                          "torch.", ""),
                                      "spec": _spec(shd[k])} for k in sds}}
                    if shape.kind == "decode":
                        cache = dryrun._cache_abstract(
                            arch, dryrun.DRYRUN_RT, shape.global_batch,
                            shape.seq_len)
                        cell["cache"] = {
                            "buggy" if buggy else "fixed": {
                                p: _spec(s) for p, s in _paths(
                                    dryrun._cache_shardings(
                                        cache, mesh,
                                        batch=shape.global_batch,
                                        buggy=buggy))
                                if not p.endswith("pos")}
                            for buggy in (True, False)}
                    placed = dryrun.prepare(arch, shape, mesh)
                    cell["args_bytes"] = sum(
                        dryrun._nbytes(t.to_local())
                        for t in dryrun._tensors(placed.args))
                    del placed
                    if shape_name in arch.skip:
                        continue
                    record = dryrun.analyze(arch, shape_name, {
                        "flops": 0.0, "bytes": 0.0, "collectives": {},
                        "collective_bytes": 0.0, "peak_bytes": 0,
                        "args_bytes": 0, "trace_wall_s": 0.0}, mesh)
                    for key in ("model_flops_total", "chips", "mesh"):
                        cell[key] = record[key]
                    if shape_name not in STAGE_SHAPES:
                        continue
                    cell["stage_predict"] = dryrun.stage_predict(
                        arch, shape_name, multi_pod=multi_pod,
                        fsdp=rec["fsdp"], zero1=dryrun.DRYRUN_RT.zero1)
    return out


@pytest.mark.parametrize("mesh,name", CELLS)
def test_arch_rules_equal_the_reference(reference, port, mesh, name):
    want, got = reference()[mesh][name], port[mesh][name]
    assert got["rules"] == want["rules"]
    assert got["fsdp"] == want["fsdp"]


@pytest.mark.parametrize("mesh,name", CELLS)
def test_batch_specs_equal_the_reference(reference, port, mesh, name):
    want, got = reference()[mesh][name], port[mesh][name]
    for shape_name in SHAPES:
        assert got["shapes"][shape_name]["batch"] \
            == want["shapes"][shape_name]["batch"], shape_name


@pytest.mark.parametrize("mesh,name", CELLS)
def test_cache_shardings_equal_the_reference(reference, port, mesh, name):
    """Every decode shape, the layer-sharding heuristic and the batch one,
    leaf by leaf (``pos`` aside: an int in the port)."""
    want, got = reference()[mesh][name], port[mesh][name]
    for shape_name, shape in SHAPES.items():
        if shape.kind == "decode":
            assert got["shapes"][shape_name]["cache"] \
                == want["shapes"][shape_name]["cache"], shape_name


@pytest.mark.parametrize("mesh,name", CELLS)
def test_rank0_argument_bytes_equal_the_reference(reference, port, mesh,
                                                  name):
    """Parameters, ZeRO-1 moments and batch (train), parameters and batch
    (prefill), parameters, cache and tokens (decode): the fake local shards
    of rank 0 against the reference's shard shapes."""
    want, got = reference()[mesh][name], port[mesh][name]
    assert {s: c["args_bytes"] for s, c in got["shapes"].items()} \
        == {s: c["args_bytes"] for s, c in want["shapes"].items()}


@pytest.mark.parametrize("mesh,name", CELLS)
def test_model_flops_equal_the_reference(reference, port, mesh, name):
    want, got = reference()[mesh][name], port[mesh][name]
    for shape_name, cell in want["shapes"].items():
        for key in ("model_flops_total", "chips", "mesh"):
            assert got["shapes"][shape_name].get(key) == cell.get(key), \
                (shape_name, key)


@pytest.mark.parametrize("mesh,name", CELLS)
def test_stage_predict_equals_the_reference(reference, port, mesh, name):
    """``stage_predict`` on ``H100_HGX`` at ``STAGE_SHAPES``."""
    want, got = reference()[mesh][name], port[mesh][name]
    for shape_name, cell in want["shapes"].items():
        assert got["shapes"][shape_name].get("stage_predict") \
            == cell.get("stage_predict"), shape_name


def test_runtime_fields_are_the_references():
    """The same field names in the same order, the same defaults but the
    attention (the port's default is its kernel)."""
    mine, ref = dataclasses.fields(RuntimeCfg), dataclasses.fields(
        JaxRuntimeCfg)
    assert [f.name for f in mine] == [f.name for f in ref]
    assert {f.name: f.default for f in mine if f.name != "attention_impl"} \
        == {f.name: f.default for f in ref if f.name != "attention_impl"}
    assert dryrun.DRYRUN_RT.attention_impl == "chunked"
    assert dryrun.DRYRUN_RT.remat == "full"


def test_constants_are_the_cards():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) \
        == (989e12, 3.35e12, 50e9) == (H100_HGX.peak_flops, H100_HGX.hbm_bw,
                                       H100_HGX.axis_bw("dp"))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_local_shape_and_offset_follow_dtensor(multi_pod):
    """``models.common.local_shape_and_offset`` (plain Python, for fake
    mode) against DTensor's own helper, even and uneven shards, nested."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.models.common import local_shape_and_offset
    with dryrun.fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        n = mesh.ndim
        cases = [((64, 96, 7), [Shard(0)] * (n - 1) + [Replicate()]),
                 ((40, 33, 5), [Shard(1)] * (n - 1) + [Shard(0)]),
                 ((3, 17), [Replicate()] * (n - 1) + [Shard(1)]),
                 ((9, 4, 128), [Shard(2)] * n)]
        for shape, pl in cases:
            assert local_shape_and_offset(shape, mesh, pl) == tuple(
                map(tuple, compute_local_shape_and_global_offset(
                    shape, mesh, pl))), (shape, pl)


def test_flop_counter_counts_a_dtensor_product_once():
    """``[4096,5120] @ [5120,17408]`` sharded (data, -) x (-, model) on 16x16:
    rank 0 multiplies [256,5120] @ [5120,1088].  ``FlopCounterMode`` around
    DTensor code also counts the global product that sharding propagation
    runs on fake tensors of its own; ``_Counter`` leaves that out."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.common import as_global
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        fake = FakeTensorMode()
        with fake:
            a = as_global(torch.empty(256, 5120, dtype=torch.bfloat16),
                          mesh, (Shard(0), Replicate()), (4096, 5120))
            w = as_global(torch.empty(5120, 1088, dtype=torch.bfloat16),
                          mesh, (Replicate(), Shard(1)), (5120, 17408))
        counter = dryrun._Counter(fake)
        with counter:
            out = a @ w
        assert tuple(out.to_local().shape) == (256, 1088)
    assert counter.flops == 2 * 256 * 5120 * 1088 == 2_852_126_720
    assert counter.collectives == {}
    # the product's operands and result, nothing of the global shapes
    assert counter.bytes == 2 * (256 * 5120 + 5120 * 1088 + 256 * 1088)


def test_skip_record(tmp_path):
    out = tmp_path / "r.jsonl"
    rec = dryrun.run_cell("qwen3-14b", "long_500k", multi_pod=False,
                          out_path=str(out), device="cpu")
    assert rec == {"arch": "qwen3-14b", "shape": "long_500k",
                   "mesh": "16x16", "status": "SKIP",
                   "reason": get("qwen3-14b").skip["long_500k"]}
    assert json.loads(out.read_text()) == rec


def test_fail_record_carries_the_error_and_its_trace(tmp_path):
    """A step that raises (here a remat mode neither package has) is a FAIL
    record, and the sweep goes on; the fake group is gone after it."""
    import torch.distributed as dist
    out = tmp_path / "r.jsonl"
    rec = dryrun.run_cell("minitron-8b", "train_4k", multi_pod=False,
                          out_path=str(out), device="cpu", label="bad",
                          rt=dataclasses.replace(dryrun.DRYRUN_RT,
                                                 remat="sometimes"))
    assert rec["status"] == "FAIL" and rec["label"] == "bad"
    assert rec["error"].startswith("ValueError: remat 'sometimes'")
    # the trace's last 2000 characters, down to the raise
    assert "in _remat" in rec["trace"] and len(rec["trace"]) <= 2000
    assert rec["trace"].rstrip().endswith(rec["error"])
    assert rec["trace_wall_s"] >= 0 and rec["mesh"] == "16x16"
    assert not dist.is_initialized()


def test_seq_axis_override_is_refused():
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="_cache_seq_axis"):
            dryrun.prepare(get("minitron-8b"), SHAPES["decode_32k"], mesh,
                           rule_overrides={"_cache_seq_axis": "model"})


def test_done_cells_and_all_resume(tmp_path, capsys):
    """OK and SKIP cells without a label are done; FAIL, labelled and
    broken lines are not.  ``--all`` runs only what is not done: here one
    SKIP cell, once."""
    out = tmp_path / "r.jsonl"
    left = ("qwen3-14b", "long_500k", "2x16x16")
    done = [{"arch": a, "shape": s, "mesh": m, "status": "OK"}
            for a in ARCHS for s in SHAPES for m in MESHES
            if (a, s, m) != left]
    lines = [json.dumps(r) for r in done] + [
        json.dumps(dict(zip(("arch", "shape", "mesh"), left),
                        status="FAIL")),
        json.dumps(dict(zip(("arch", "shape", "mesh"), left), status="OK",
                        label="x")),
        "{not json"]
    out.write_text("\n".join(lines) + "\n")
    assert dryrun.done_cells(str(out)) == {
        (r["arch"], r["shape"], r["mesh"]) for r in done}
    dryrun.main(["--all", "--out", str(out), "--device", "cpu"])
    new = out.read_text().splitlines()[len(lines):]
    assert [json.loads(x)["status"] for x in new] == ["SKIP"]
    assert tuple(json.loads(new[0])[k] for k in ("arch", "shape", "mesh")) \
        == left
    assert "qwen3-14b long_500k 2x16x16: SKIP" in capsys.readouterr().out
    dryrun.main(["--all", "--out", str(out), "--device", "cpu"])
    assert len(out.read_text().splitlines()) == len(lines) + 1


def test_cli_needs_a_card_or_cpu(tmp_path):
    """Without a card and without ``--device cpu`` the CLI raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                     "--out", str(tmp_path / "r.jsonl")])


def test_summary_table(tmp_path, capsys):
    """``--summary`` prints one row a record: an OK cell's counts in TFLOP
    and GiB with the ratios against ``stage_predict``, a SKIP's reason, a
    FAIL's error on one line."""
    out = tmp_path / "r.jsonl"
    ok = {"arch": "a", "shape": "train_4k", "mesh": "16x16", "status": "OK",
          "flops_per_dev": 2e12, "bytes_per_dev": 3 * 2**30,
          "collectives": {"all-gather": 2**29, "all-to-all": 2**30},
          "t_compute_s": 0.004, "t_memory_s": 0.001, "t_collective_s": 0.002,
          "peak_memory_per_dev_gb": 6.0, "args_gb": 2.0, "trace_wall_s": 9.5,
          "stage_predict": {"step_ms": 2.0, "peak_gb": 3.0}}
    out.write_text("\n".join(json.dumps(r) for r in (
        ok, {"arch": "a", "shape": "long_500k", "mesh": "16x16",
             "status": "SKIP", "reason": "no"},
        {"arch": "a", "shape": "decode_32k", "mesh": "2x16x16",
         "status": "FAIL", "error": "ValueError: x |\ny",
         "trace_wall_s": 0.1})) + "\n")
    dryrun.main(["--summary", "--out", str(out)])
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 5
    assert rows[2] == ("| a · train_4k · 16x16 | OK | 9.5 | 2 | 3 | "
                       "0.5 / 0 / 0 / 1 | 6 (2) | 2 | 2 |")
    assert rows[3].startswith("| a · long_500k · 16x16 | SKIP |  | no |")
    assert "| ValueError: x / y |" in rows[4]
