"""The plain reference against the port at a smoke size on the CPU: in
float32 both sides agree to rounding (prefill: one dispatch of the whole
batch; decode: the engine's steps, one dispatch a step), and the harness's
bf16 runs come out correct."""
import json

import pytest
import torch

from portbench import spec as S
from portbench import weights as W
from portbench.reference.model import Reference
from portbench.tests.helpers import CELLS, load, run


@pytest.mark.parametrize("name", ["smoke-deepseek", "smoke-jamba"])
def test_reference_is_the_port_in_float32(name):
    from repro_torch.models import lm
    cfg = load(name)
    cfg["served_dtype"] = "float32"
    tree = W.make_weights(cfg, 2 ** 31 + 9, torch.device("cpu"))
    spec, rt = S.port_spec(cfg), S.runtime(cfg)
    W.check_against_port(tree, lm.param_axes(spec))
    tok = torch.randint(1, cfg["vocab_size"], (3, 40),
                        generator=torch.Generator().manual_seed(0))
    ref = Reference(cfg, tree)
    with torch.no_grad():
        got = lm.forward(tree, tok, spec, rt)
    want = ref.logits(ref.hidden(tok, "batch"))
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    cache = lm.init_cache(spec, rt, 3, 64, device="cpu")
    steps = []
    for t in range(24):
        lg, cache = lm.decode_step(tree, cache, tok[:, t:t + 1], spec, rt)
        steps.append(lg[:, 0])
    want = ref.logits(ref.hidden(tok[:, :24], "step"))
    assert (torch.stack(steps, 1) - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct(cell):
    line, lines = run(cell, seed=2)
    assert line["correct"], lines
    assert list(line)[-1] == "checks"
    assert all(k in line for k in ("attempted", "failed", "metrics", "device"))
    assert lines[-1].startswith("check ")
    json.dumps(line)


def test_a_traced_run_on_the_cpu_reads_no_device_metric():
    line, _ = run("jamba52b.decode-chat8", seed=3, trace=True)
    assert line["correct"]
    assert "busy_s" in line["device"] and "breakdown" in line
    # gen_share and mfu come from counts and the host clock; nothing from
    # a device trace is written for a CPU run
    assert not {"idle_share.decode", "flash_roofline.decode",
                "moe_ms.decode"} & set(line["metrics"])
