"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: it trains, saves at step 10, and a rerun in the same directory
resumes there, printing the JAX package's lines; without a card it raises
unless asked for the CPU.  whisper-medium cannot be trained by either
package's launcher: the token pipeline makes no frames for its encoder."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.ckpt import latest_step
from repro_torch.configs import ARCHS, get
from repro_torch.launch import train as launcher
from repro_torch.models import param_axes

ROOT = Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"^step +(\d+) loss \d+\.\d{4} \(\d+\.\d{2}s\) "
                       r"\[(ok|warn|evict)\]$")
TRAINABLE = [a for a in ARCHS if a != "whisper-medium"]


def _run(capsys, *args) -> list:
    launcher.main(["--smoke", "--device", "cpu", *args])
    return capsys.readouterr().out.splitlines()


def test_trains_saves_at_ten_and_resumes(capsys, tmp_path):
    """The reference's wiring at its defaults (batch 4, seq 64): the lines
    it prints, a checkpoint at step 10 whose manifest holds the
    parameters' logical axes, and a rerun to 12 that resumes at 10."""
    d = str(tmp_path)
    out = _run(capsys, "--arch", "qwen3-14b", "--ckpt-dir", d, "--steps",
               "10")
    assert re.fullmatch(r"training qwen3-smoke: \d+\.\dM params, 1 devices",
                        out[0])
    assert out[1].startswith("[train] STAGE pre-flight: qwen3-smoke/train "
                             "b=4 s=64")
    assert [int(STEP_LINE.match(line).group(1)) for line in out[2:-1]] \
        == list(range(10))
    assert out[-1] == "done"
    assert latest_step(d) == 10 and os.listdir(d) == ["step_00000010"]
    man = json.load(open(os.path.join(d, "step_00000010", "manifest.json")))
    axes = {e["path"]: e["axes"] for e in man["entries"]}
    assert axes["/params/embed"] == list(param_axes(get("qwen3-14b").smoke)
                                         ["embed"])
    assert axes["/params/slots/0/attn/w_q"][0] == "layers"
    moments = [p for p in axes if not p.startswith("/params")]
    assert moments and all(axes[p] is None for p in moments)

    out = _run(capsys, "--arch", "qwen3-14b", "--ckpt-dir", d, "--steps",
               "12")
    assert out[2] == "resumed at step 10"
    assert [int(STEP_LINE.match(line).group(1)) for line in out[3:-1]] \
        == [10, 11]
    assert out[-1] == "done"


@pytest.mark.parametrize("arch", TRAINABLE)
def test_every_arch_trains_and_resumes(capsys, tmp_path, arch):
    """Each trainable arch's smoke spec at [2, 32]: losses finite, a save at
    10, the rerun resumes there with the saved step count and trains on."""
    d = str(tmp_path)
    kw = dict(steps=10, batch=2, seq=32, ckpt_dir=d, device="cpu")
    spec = get(arch).smoke
    first = launcher.train(spec, **kw)
    assert first["start"] == 0 and sorted(first["save_s"]) == [10]
    again = launcher.train(spec, **{**kw, "steps": 12})
    assert again["start"] == 10 and sorted(again["losses"]) == [10, 11]
    assert int(again["opt"]["step"]) == 12
    losses = list(first["losses"].values()) + list(again["losses"].values())
    assert all(torch.isfinite(torch.tensor(losses)))
    assert "resumed at step 10" in capsys.readouterr().out.splitlines()


def test_whisper_needs_frames_as_in_the_reference(tmp_path):
    """The reference's launcher fails on whisper-medium (``_run_encoder``
    gets ``frames=None``, ``src/repro/models/lm.py:197``); the port's
    raises the ValueError that names the missing frames."""
    with pytest.raises(ValueError, match="frames"):
        launcher.train(get("whisper-medium").smoke, steps=1, batch=2, seq=32,
                       ckpt_dir=str(tmp_path), device="cpu")


def test_without_a_card_it_raises_unless_asked_for_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train`` without ``--device cpu`` on a
    machine without CUDA: a non-zero exit naming ``--device cpu``, no
    step trained."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-14b", "--smoke", "--steps", "1", "--ckpt-dir",
         str(tmp_path)],
        capture_output=True, text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert not any(STEP_LINE.match(line) for line in r.stdout.splitlines())
