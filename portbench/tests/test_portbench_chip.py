"""On the card only (marker ``chip``): one short run of a cell through the
command the benchmark is run by, its last line parsed as JSON; and
DeepSeek-V2's MLA layers at their published widths against their plain
reference, for a configuration that has no cell yet."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["jamba52b.decode-chat8",
                                  "jamba52b.prefill-mix8k"])
def test_a_short_run_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                        "--seed", "2147483901", "--seconds", "3", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], r.stderr[-3000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"]


def _deepseek_v2_prefill(card, seed: int, dtype: str) -> tuple:
    """DeepSeek-V2 at its published widths, cut to the dense layer and four
    MoE layers of all 160 experts, served in ``dtype`` through the port's
    ``make_prefill`` on one batch of 2 x 2048 with the benchmark's weights
    -> (the config, the weights, the tokens, the last-position logits in
    float32, the peak bytes)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.serve.engine import make_prefill
    from portbench import spec as S
    from portbench import weights as W
    from portbench.tests.helpers import deepseek_v2
    cfg = dict(deepseek_v2(layers=5), served_dtype=dtype)
    torch.cuda.set_device(card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(card)
    tree = W.make_weights(cfg, seed, card)
    spec, rt = S.port_spec(cfg), S.runtime(cfg)
    W.check_against_port(tree, lm.param_axes(spec))
    _build.build_all()
    gen = torch.Generator(device=card).manual_seed(seed)
    toks = torch.randint(1, cfg["vocab_size"], (2, 2048), generator=gen,
                         device=card)
    got = make_prefill(spec, rt)(tree, toks)[:, 0].float()
    torch.cuda.synchronize(card)
    return cfg, tree, toks, got, torch.cuda.max_memory_allocated(card)


def _against(want, lg) -> dict:
    """The readings of logits ``lg`` [B, V] against the reference's."""
    best = want.max(-1).values
    gap = best - want.gather(1, lg.argmax(-1)[:, None])[:, 0]
    rel = (lg - want).norm(dim=-1) / want.norm(dim=-1)
    return {"top_gap.mean": float(gap.mean()), "top_gap.max": float(gap.max()),
            "logit_rel_err.mean": float(rel.mean()),
            "logit_rel_err.max": float(rel.max())}


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2147483921, 2147483922, 2147483923])
def test_deepseek_v2_prefill_against_its_reference(card, seed):
    """The port in bfloat16 (``_deepseek_v2_prefill``): its last-position
    logits against ``reference/deepseek_v2.py`` in float32, and the float8
    control against the same.  Prints the readings, the peak and the
    reference's seconds."""
    import torch
    from portbench.reference.model import Reference
    cfg, tree, toks, got, peak = _deepseek_v2_prefill(card, seed, "bfloat16")
    cf = cfg["assumed"]["moe_capacity_factor"]
    seconds, want, sides = {}, None, {"port": got}
    for precision in ("fp32", "fp8"):
        t0 = time.perf_counter()
        ref = Reference(cfg, tree, precision, cf)
        lg = ref.logits(ref.hidden(toks, "batch")[:, -1])
        torch.cuda.synchronize(card)
        seconds[precision] = time.perf_counter() - t0
        if want is None:
            want = lg
        else:
            sides["control"] = lg
    read = {}
    for side, lg in sides.items():
        assert torch.isfinite(lg).all(), side
        read[side] = _against(want, lg)
    print(json.dumps({"deepseek-v2.d5 prefill 2x2048 seed": seed,
                      "readings": read, "memory_peak_bytes": peak,
                      "reference_s": seconds,
                      "device": torch.cuda.get_device_name(card)}))
    assert read["port"]["logit_rel_err.mean"] \
        < read["control"]["logit_rel_err.mean"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2147483922, 2147483923])
def test_deepseek_v2_in_float32_is_its_reference(card, seed):
    """The float32 witness of the test above, at the same size: the port
    served in float32 reads what ``reference/deepseek_v2.py`` reads, to
    rounding, so what the bfloat16 port departs by is its precision."""
    import torch
    from portbench.reference.model import Reference
    cfg, tree, toks, got, peak = _deepseek_v2_prefill(card, seed, "float32")
    ref = Reference(cfg, tree, "fp32", cfg["assumed"]["moe_capacity_factor"])
    read = _against(ref.logits(ref.hidden(toks, "batch")[:, -1]), got)
    print(json.dumps({"deepseek-v2.d5 prefill 2x2048 float32 seed": seed,
                      "readings": read, "memory_peak_bytes": peak,
                      "device": torch.cuda.get_device_name(card)}))
    assert read["logit_rel_err.max"] <= 1e-4 and read["top_gap.max"] == 0
