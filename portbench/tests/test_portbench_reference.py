"""The plain reference against the port at a smoke size on the CPU: in
float32 both sides agree to rounding (prefill: one dispatch of the whole
batch; decode: the engine's steps, one dispatch a step), and the harness's
bf16 runs come out correct."""
import hashlib
import json

import pytest
import torch

from portbench import roofline
from portbench import spec as S
from portbench import weights as W
from portbench.reference.model import Reference
from portbench.tests.helpers import CELLS, load, run


@pytest.mark.parametrize("name", ["smoke-deepseek", "smoke-jamba",
                                  "smoke-deepseek-v2"])
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


def readings(name: str) -> dict:
    """What the reference and the yardstick read of a smoke config, each
    as the sha256 of its float32 bytes: the weight tree, the fp32 logits
    of a prefill (one dispatch) and of engine steps, the fp8 control's, and
    the model FLOPs of 7 tokens attending 12 345 positions."""
    cfg = load(name)
    tree = W.make_weights(cfg, 2 ** 31 + 11, torch.device("cpu"))
    tok = torch.randint(1, cfg["vocab_size"], (2, 24),
                        generator=torch.Generator().manual_seed(1))
    out = {"weights": torch.cat([t.float().reshape(-1) for _, t
                                 in W._leaves(tree)])}
    for precision, grouping in (("fp32", "batch"), ("fp32", "step"),
                                ("fp8", "batch")):
        ref = Reference(cfg, tree, precision)
        out[f"{precision}.{grouping}"] = ref.logits(ref.hidden(tok, grouping))
    out["model_flops"] = torch.tensor([roofline.model_flops(cfg, 7, 12345)],
                                      dtype=torch.float64)
    return {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
            for k, v in out.items()}


@pytest.mark.parametrize("name", ["smoke-deepseek", "smoke-jamba"])
def test_the_default_kinds_read_as_before(name):
    # the digests were taken from the harness before configurations could
    # bring their own layer kinds (parent-readings.json): a config of the
    # harness's own kinds reads the same weights, logits and FLOPs, bit for
    # bit
    assert readings(name) == load("parent-readings")[name]


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
