"""The port on a (2, 4) ("data", "model") DeviceMesh of 8 gloo ranks: the
expert-parallel MoE branch (all-to-all, ZeRO-3 gathers), a train step with
DTensor parameters and ZeRO-1 moments, served decode, the kernel entries
on local shards, checkpoints placed by ``shardings=``, and what must raise.
As ``tests/test_multidevice.py`` does for the JAX package with 8
placeholder devices, the ranks run in a subprocess
(``tests/torch_multirank_worker.py``, one spawn for every check), so that no
process group lives in a pytest worker; each check is a test here.  The
single-device results they are held against are held against the JAX
package by ``tests/test_torch_moe.py`` and ``tests/test_torch_train.py``.
Bounds (fp32, the same arithmetic in another order): the EP branch within
1e-5 * max|single-device| + 1e-6, every train-step leaf within 1e-4 *
max|leaf| + 1e-6, the loss within 1e-5 relative."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_multirank_worker import CHECKS, LOSS_REL

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("multirank") / "results.json"
    # one thread a rank: the 8 ranks share the host with the other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "torch_multirank_worker.py"),
                        str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(out.read_text())


def _ok(results, name) -> dict:
    got = results[name]
    assert got["ok"], got["detail"]
    return got["detail"]


@pytest.mark.parametrize("name", [n for n in CHECKS if n.startswith("ep_")])
def test_expert_parallel_moe_matches_single_device(results, name):
    """Output and the gradients of x and every weight; at decode every
    model peer routes the same tokens and each one's gradient counts once."""
    d = _ok(results, name)
    assert d["out"] <= 1.0 and d["grads"] <= 1.0, d
    want = "(Shard(dim=1), Shard(dim=0))" if "gather" in name \
        else "(Replicate(), Shard(dim=0))"
    assert d["weights"]["w_egate"] == want, d["weights"]


@pytest.mark.parametrize("name", ["train_step[dense]", "train_step[moe]"])
def test_train_step_on_the_mesh_matches_plain(results, name):
    d = _ok(results, name)
    assert d["loss_rel"] <= LOSS_REL and d["step_loss_rel"] <= LOSS_REL, d
    assert d["grad_norm_rel"] <= LOSS_REL, d
    assert d["grads"] <= 1.0 and d["params"] <= 1.0 and d["moments"] <= 1.0
    assert d["step"] == 1


def test_zero1_moments_keep_their_shards(results):
    """The moments stay on the ZeRO-1 placements after the update, and
    where the parameter has no data shard (no FSDP) they take one."""
    dense, moe = (_ok(results, f"train_step[{k}]") for k in ("dense", "moe"))
    assert dense["moments_keep_zero1"] and moe["moments_keep_zero1"]
    assert dense["moments_sharded_beyond_params"] > 0
    # with FSDP the parameters hold the data axis already: nothing to add
    assert moe["moments_sharded_beyond_params"] == 0


@pytest.mark.parametrize("name", [n for n in CHECKS
                                  if n.startswith("decode")])
def test_decode_on_the_mesh_gives_the_same_tokens(results, name):
    d = _ok(results, name)
    assert d["tokens_equal"], d
    assert d["prefill"] <= 1.0, d


def test_kernel_entries_run_on_local_shards(results):
    d = _ok(results, "kernel_entries")
    assert d["calls"] == 3 and not d["dtensor_reached"], d
    assert d["flash"]["err"] <= 1.0 and d["wkv6"]["err"] <= 1.0
    assert d["cost_reduce"]["err"] <= 1.0
    # the sequence shards are gathered; batch and heads keep theirs
    assert d["flash"]["placements"] == "(Shard(dim=0), Replicate())"
    assert d["wkv6"]["placements"] == "(Shard(dim=0), Shard(dim=2))"
    assert d["cost_reduce"]["placements"] == "(Shard(dim=1), Shard(dim=0))"


def test_checkpoint_of_a_placed_state(results):
    d = _ok(results, "checkpoint")
    assert d == {"same_bytes": True, "dtensors": True,
                 "placements_equal": True, "bit_equal": True, "step": 1}


def test_what_must_raise_on_the_mesh(results):
    """The production mesh on 8 ranks and a spec out of mesh order raise;
    a decode cache sharded over its layers dimension (the JAX package's
    heuristic where the depth divides the data degree) no longer does: six
    greedy steps through it give the replicated cache's tokens, logits and
    cache, bit for bit."""
    d = _ok(results, "refusals")
    assert "needs a process group of 256 ranks; this one has 8" \
        in d["production"], d
    assert "out of the mesh's axis order" in d["order"], d
    rows = d["rows"]
    assert rows["layer_sharded_leaves"] == 2, rows      # k and v
    assert rows["tokens_equal"] and rows["logits_equal"], rows
    assert rows["cache_equal"], rows
