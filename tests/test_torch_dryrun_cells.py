"""The port's dry run stepping smoke specs on the fake 256-rank (16x16) and
512-rank (2x16x16) process groups (``device="cpu"``, fake tensors) through
the mesh helper ``dryrun.lower_on``: training, prefill and decode of each
family, the expert-parallel branch (experts widened to 16 so that they
divide the model axis), a decode cache sharded over its layers dimension
(depth 16, as the JAX package's heuristic places minitron-8b's at 32);
each step's counts finite and positive.  And the card check rehearsed on
a one-rank gloo mesh: the same step under fake tensors and for real gives
the same FLOPs, bytes and peak.  (The prefill's extrapolation over
repeats: ``tests/test_torch_dryrun_repeats.py``.)"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import ShapeSpec, get
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

SEQ, BATCH = 64, 32            # the batch divides both data degrees


def _arch(name: str, **spec_kw):
    arch = get(name)
    spec = arch.smoke
    if spec.moe is not None:
        spec = dataclasses.replace(spec, moe=dataclasses.replace(
            spec.moe, n_experts=16))
    return dataclasses.replace(arch, spec=dataclasses.replace(spec,
                                                              **spec_kw))


@pytest.fixture(scope="module")
def meshes():
    """Both production meshes, each on its own fake group, made one after
    the other: yields a function that runs ``fn(mesh)`` on one of them."""
    def on(multi_pod: bool, fn):
        with dryrun.fake_group(512 if multi_pod else 256):
            return fn(make_production_mesh(multi_pod=multi_pod,
                                           device="cpu"))
    return on


def _check(counts: dict) -> None:
    for key in ("flops", "bytes", "peak_bytes", "args_bytes"):
        assert math.isfinite(counts[key]) and counts[key] > 0, (key, counts)
    assert counts["peak_bytes"] >= counts["args_bytes"]
    assert all(v > 0 for v in counts["collectives"].values())


# (each family's prefill also runs in tests/test_torch_dryrun_repeats.py)
CELLS = [("qwen3-14b", k, False) for k in ("train", "prefill", "decode")] \
    + [("deepseek-v2-236b", "train", False),
       ("deepseek-moe-16b", "decode", True),
       ("rwkv6-7b", "decode", True),
       ("jamba-v0.1-52b", "decode", False),
       ("internvl2-26b", "prefill", True),
       ("gemma2-27b", "decode", False)]


@pytest.mark.parametrize("name,kind,multi_pod", CELLS)
def test_smoke_cell_runs_on_the_fake_group(meshes, name, kind, multi_pod):
    from repro_torch.kernels import selective_scan
    arch = _arch(name)
    before = selective_scan.launches
    counts, meta = meshes(multi_pod, lambda m: dryrun.lower_on(
        arch, ShapeSpec(kind, SEQ, BATCH, kind), m))
    _check(counts)
    # fake tensors on a mesh: the Mamba scan takes its plain path
    assert selective_scan.launches == before
    if arch.spec.moe is not None:
        # the expert-parallel branch: dispatch and combine over model
        assert counts["collectives"]["all-to-all"] > 0
        assert meta["fsdp"]


def test_decode_through_a_layer_sharded_cache(meshes):
    """minitron-8b's cell in small: the JAX package's heuristic shards the
    cache's layers dimension where the depth divides the data degree; each
    layer's row is then broadcast from its owners (an all-reduce of a zero
    and a row) and written back."""
    arch = _arch("minitron-8b", n_layers=16)

    def run(mesh):
        cell = dryrun.prepare(arch, ShapeSpec("d", SEQ, BATCH, "decode"),
                              mesh)
        k = cell.args[1]["slots"][0]["attn"]["k"]
        return str(k.placements), tuple(k.to_local().shape), \
            dryrun.count(cell)
    placements, local, counts = meshes(False, run)
    assert placements == "(Shard(dim=0), Replicate())"
    assert local[0] == 1                       # 16 layers over data 16
    _check(counts)
    row = math.prod(local[1:]) * 2             # bf16 k of one layer
    # k and v of each of the 16 layers, one row each
    assert counts["collectives"]["all-reduce"] >= 2 * 16 * row


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_fake_and_real_counts_agree(kind):
    """The card check's comparison on a one-rank gloo mesh: one step
    under fake tensors, then for real under the same counting mode.  FLOPs,
    bytes and collectives equal, and the fake peak equals the real run's
    counted peak (the card check holds it against the allocator)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    arch = _arch("qwen3-14b")
    rt = dataclasses.replace(dryrun.DRYRUN_RT, attn_chunk=16, loss_chunk=16)
    shape = ShapeSpec(kind, 32, 2, kind)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        fake, _ = dryrun.lower_on(arch, shape, mesh, rt=rt)
        real, _ = dryrun.lower_on(arch, shape, mesh, rt=rt, fake=False)
    finally:
        dist.destroy_process_group()
    for key in ("flops", "bytes", "collectives", "peak_bytes",
                "args_bytes"):
        assert fake[key] == real[key], key
    assert fake["flops"] > 0 and fake["bytes"] > 0
    assert torch.is_grad_enabled()
