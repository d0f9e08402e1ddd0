"""The dry run's prefill shortcut (``dryrun.lower_by_repeats``: the step
run at ``dryrun.REPEATS`` repeats of the layer period and extrapolated)
against the full loop, for the smoke spec of every arch it serves (all
but jamba, whose 4 repeats the dry run runs whole) on the fake 256-rank
group (``device="cpu"``): at four repeats every count is equal (FLOPs,
bytes, collectives by kind, peak and argument bytes), with the chunked
attention looping and padding (``attn_chunk`` 16 under 24 tokens).
Experts are widened to 16, so that the expert-parallel branch runs."""
import dataclasses

import pytest

from repro_torch.configs import ARCHS, ShapeSpec, get
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh


def _arch(name: str):
    arch = get(name)
    spec = arch.smoke
    if spec.moe is not None:
        spec = dataclasses.replace(spec, moe=dataclasses.replace(
            spec.moe, n_experts=16))
    return dryrun._with_repeats(dataclasses.replace(arch, spec=spec), 4)


# every arch whose prefill the dry run counts by repeats: jamba's 4 repeats
# are run whole
@pytest.mark.parametrize("name", [a for a in ARCHS
                                  if a != "jamba-v0.1-52b"])
def test_prefill_repeats_extrapolate_exactly(name):
    arch = _arch(name)
    rt = dataclasses.replace(dryrun.DRYRUN_RT, attn_chunk=16)
    shape = ShapeSpec("p", 24, 32, "prefill")
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        full, _ = dryrun.lower_on(arch, shape, mesh, rt=rt)
        ext, _ = dryrun.lower_by_repeats(arch, shape, mesh, rt=rt)
    assert ext.pop("repeats") == {"counted": [2, 3], "of": 4}
    full.pop("trace_wall_s")
    ext.pop("trace_wall_s")
    assert ext == full
    assert full["flops"] > 0 and full["peak_bytes"] > full["args_bytes"]
