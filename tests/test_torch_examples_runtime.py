"""The runtime twins, ``examples_torch/serve_batched.py`` and
``examples_torch/train_lm.py``, against the JAX examples on the CPU.

Each twin runs in a subprocess with ``--device cpu`` beside its example:
the same lines, but for what the weights decide (the twin draws its own
from a ``torch.Generator`` seeded 0, the example from ``PRNGKey(0)``) and
what reads the clock.  Then the twin's ``main`` runs in this process on
the example's own weights, carried across by ``models/convert.py``:

* serve_batched (bf16, naive attention): the same tokens for each of the 8
  requests, except that a request's greedy pick may part from the
  example's where the two are a near-tie in bf16: the example's pick within
  ``TIE_ULPS`` bf16 ulps of the step's best logit in the twin (bf16 keeps 8
  significant bits, and the two packages round different intermediates).
  On this seed 5 requests are equal and 3 part at gaps of 1, 0 and 2 ulps.
  In float32 on both sides (the example's engine in this process, the
  twin's ``RuntimeCfg`` patched) all 8 requests' tokens are equal;
* train_lm (6 steps at width 128, 2 layers, bf16): every printed loss
  within ``LOSS_REL`` of the example's and the same learning rates; and
  a crash at step 20 and a rerun that resumes there give the losses of an
  uninterrupted run, bit for bit."""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import torch

from repro.core import ModelSpec as JaxModelSpec
from repro.models import RuntimeCfg as JaxRuntimeCfg
from repro.models import init_params as jax_init_params
from repro.models.common import pvalue
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.models import RuntimeCfg, params_from_reference
from repro_torch.serve import Engine
from repro_torch.train.tree import leaves

from torch_port_helpers import assert_same_output, run_example_pair

ROOT = Path(__file__).resolve().parents[1]
TIE_ULPS = 4
LOSS_REL = 3e-4
TRAIN_ARGS = ("--steps", "6", "--d-model", "128", "--layers", "2",
              "--batch", "2", "--seq", "32")
REQUEST = r"^request (\d+): prompt\[(\d+)\] -> (\[.*\])$"


def _twin(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"twin_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_spec(spec):
    return JaxModelSpec(**{f.name: getattr(spec, f.name)
                           for f in dataclasses.fields(spec)})


def _jax_weights(spec, rt, with_reference=False):
    """The JAX example's parameters (``PRNGKey(0)``) as the port's tree
    (and the reference's own tree, ``with_reference``)."""
    params = jax_init_params(_jax_spec(spec), rt, jax.random.PRNGKey(0))
    port = params_from_reference(jax.tree.map(np.asarray, pvalue(params)),
                                 device="cpu")
    return (port, params) if with_reference else port


def _serve_requests(engine, request_cls, vocab):
    """The example's 8 requests, submitted as it submits them."""
    rng = np.random.RandomState(0)
    for rid in range(8):
        engine.submit(request_cls(
            rid=rid, prompt=rng.randint(1, vocab, size=rng.randint(3, 9)),
            max_new=12))


def _requests(lines) -> dict:
    return {int(m.group(1)): (int(m.group(2)), eval(m.group(3)))
            for m in map(lambda s: re.match(REQUEST, s), lines) if m}


def test_serve_batched_twin(tmp_path, capsys):
    jax_lines, torch_lines = run_example_pair(
        "serve_batched", tmp_path,
        twin_args=("--device", "cpu", "--attention-impl", "naive"))
    # the seeded twin: the same pre-flight and closing lines and requests
    # (prompt lengths, 12 tokens each); its tokens are its own weights'
    assert_same_output("serve_batched", jax_lines, torch_lines, {
        "the tokens (the twin's own weights)": (r"-> \[.*\]$", "-> <tokens>")})
    want = _requests(jax_lines)
    assert len(want) == 8 and all(len(t) == 12 for _, t in want.values())

    twin = _twin("serve_batched")
    params = _jax_weights(twin.spec, JaxRuntimeCfg(attention_impl="naive"))
    logits: dict = {}                 # request -> its pick steps' logits

    class Recording(Engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            step = self.step_fn

            def recorded(p, cache, tokens):
                out, cache = step(p, cache, tokens)
                for i, req in enumerate(self.slots):
                    if req is not None and req._fed >= len(req.prompt):
                        logits.setdefault(req.rid, []).append(
                            out[i, 0].float().clone())
                return out, cache
            self.step_fn = recorded
    twin.Engine = Recording
    capsys.readouterr()
    done = twin.main(["--device", "cpu", "--attention-impl", "naive"],
                     params=params)
    got_lines = capsys.readouterr().out.splitlines()
    got = {r.rid: r.out for r in done}
    assert sorted(got) == sorted(want)
    parted = {}
    for rid, (_, toks) in want.items():
        k = next((i for i, (a, b) in enumerate(zip(toks, got[rid]))
                  if a != b), None)
        if k is None:
            continue
        row = logits[rid][k]
        best = float(row.max())
        ulp = 2.0 ** (np.floor(np.log2(abs(best))) - 7)
        gap = (best - float(row[toks[k]])) / ulp
        assert gap <= TIE_ULPS, (rid, k, gap)
        parted[rid] = (k, gap)
    assert len(parted) <= 3, parted
    # every request that did not part prints the example's line
    for line in got_lines:
        m = re.match(REQUEST, line)
        if m and int(m.group(1)) not in parted:
            assert line in jax_lines, line

    # in float32 on both sides (the example's engine run here, the twin's
    # RuntimeCfg patched as its Engine is) every request's tokens are equal
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    jax_rt = JaxRuntimeCfg(attention_impl="naive", **f32)
    params, jax_params = _jax_weights(twin.spec, jax_rt, with_reference=True)
    engine = JaxEngine(_jax_spec(twin.spec), jax_rt, jax_params,
                       batch_slots=4, kv_len=128)
    _serve_requests(engine, JaxRequest, twin.spec.vocab)
    want32 = {r.rid: r.out for r in engine.run(max_steps=200)}
    twin.Engine = Engine
    twin.RuntimeCfg = lambda **kw: RuntimeCfg(**f32, **kw)
    done = twin.main(["--device", "cpu", "--attention-impl", "naive"],
                     params=params)
    capsys.readouterr()
    assert {t.dtype for t in leaves(params)} == {torch.float32}
    assert sorted(want32) == list(range(8))
    assert {r.rid: r.out for r in done} == want32


def _losses(lines) -> dict:
    return {int(m.group(1)): (float(m.group(2)), m.group(3)) for m in (
        re.match(r"^step\s+(\d+)\s+loss (\S+)\s+gnorm \S+\s+lr (\S+)", s)
        for s in lines) if m}


# the watchdog's decision reads the step's wall-clock time, as the
# seconds column does
TRAIN_MASKS = {
    "the loss and gradient norm (the weights decide them)": (
        r"loss \S+  gnorm \S+", "loss <l>  gnorm <g>"),
    "the step's seconds and the watchdog's decision": (
        r"  \d+\.\d+s  \[\w+\]$", "  <s>  [<kind>]"),
}


def test_train_lm_twin(tmp_path, capsys):
    jax_lines, torch_lines = run_example_pair(
        "train_lm", tmp_path,
        jax_args=TRAIN_ARGS + ("--ckpt-dir", str(tmp_path / "j")),
        twin_args=TRAIN_ARGS + ("--ckpt-dir", str(tmp_path / "t0"),
                                "--device", "cpu"))
    assert_same_output("train_lm", jax_lines, torch_lines, TRAIN_MASKS)

    twin = _twin("train_lm")
    spec = JaxModelSpec(name="train-demo", n_layers=2, d_model=128,
                        n_heads=2, n_kv_heads=1, d_ff=512, vocab=8192)
    params = _jax_weights(spec, JaxRuntimeCfg(attention_impl="chunked",
                                              attn_chunk=128))
    capsys.readouterr()
    losses = twin.main(list(TRAIN_ARGS) + ["--ckpt-dir", str(tmp_path / "t1"),
                                           "--device", "cpu"], params=params)
    printed = _losses(capsys.readouterr().out.splitlines())
    want = _losses(jax_lines)
    assert sorted(printed) == sorted(want) == [0, 5]
    for step, (loss, lr) in want.items():
        assert abs(losses[step] - loss) <= LOSS_REL * abs(loss), \
            (step, losses[step], loss)
        assert printed[step][1] == lr

    # a crash at step 20 (the checkpoint's step) and a rerun that resumes
    # there, against one uninterrupted run: every loss bit for bit
    small = ["--steps", "24", "--d-model", "64", "--layers", "1",
             "--vocab", "256", "--batch", "2", "--seq", "16",
             "--device", "cpu"]
    whole = twin.main(small + ["--ckpt-dir", str(tmp_path / "whole")])
    crashed = twin.main(small + ["--ckpt-dir", str(tmp_path / "crash"),
                                 "--crash-at", "20"])
    resumed = twin.main(small + ["--ckpt-dir", str(tmp_path / "crash")])
    out = capsys.readouterr().out
    assert "simulated crash at step 20; rerun to resume" in out
    assert "resumed from step 20" in out
    assert sorted(crashed) == list(range(20))
    assert sorted(resumed) == list(range(20, 24))
    assert {**crashed, **resumed} == whole
    assert all(np.isfinite(v) for v in whole.values())
