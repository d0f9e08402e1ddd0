"""The output check fails what it should: with the timed path broken
underneath (a decode step that leaves its state unchanged, half of the
batch left out, a token or an answer altered where it is produced) and
with the control, the reference in float8 put in the program's place.  The
harness's look for a card is skipped: these run on the CPU at a smoke
size."""
import contextlib
import time

import pytest
import torch

from portbench import core
from portbench.tests.helpers import DECODE, PREFILL, fixed_clock, run, smoke


def _decode_fault(kind):
    from repro_torch.models import lm
    inner = lm.decode_step

    def step(params, cache, tokens, *a, **kw):
        if kind == "state unchanged":
            saved = [t.clone() for t in _tensors(cache)]
        logits, new = inner(params, cache, tokens, *a, **kw)
        if kind == "state unchanged":
            for t, s in zip(_tensors(cache), saved):
                t.copy_(s)
            new = cache
        elif kind == "token altered":
            logits = logits.roll(1, dims=-1)
        elif kind == "half the batch":
            b = logits.shape[0] // 2
            logits = torch.cat([logits[:b], logits[:logits.shape[0] - b]])
        return logits, new
    return lm, "decode_step", step


def _prefill_fault(kind):
    from repro_torch.models import lm
    inner = lm.forward

    def forward(*a, **kw):
        logits = inner(*a, **kw)
        if kind == "answer altered":
            return logits.roll(1, dims=-1)
        b = logits.shape[0] // 2
        if b:
            logits = torch.cat([logits[:b], logits[:logits.shape[0] - b]])
        return logits
    return lm, "forward", forward


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@contextlib.contextmanager
def planted(mod, name, fn):
    inner = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, inner)


@pytest.mark.parametrize("cell", DECODE)
@pytest.mark.parametrize("kind", ["state unchanged", "token altered",
                                  "half the batch"])
def test_a_broken_decode_is_not_correct(cell, kind):
    with planted(*_decode_fault(kind)):
        line, lines = run(cell, seed=4)
    assert not line["correct"], lines


@pytest.mark.parametrize("cell", PREFILL)
@pytest.mark.parametrize("kind", ["answer altered", "half the batch"])
def test_a_broken_prefill_is_not_correct(cell, kind):
    with planted(*_prefill_fault(kind)):
        line, lines = run(cell, seed=4)
    assert not line["correct"], lines


@pytest.mark.parametrize("cell", DECODE + PREFILL)
def test_the_control_is_not_correct(cell):
    s = smoke(cell)
    ctx = core.setup(s["cell"], 5, torch.device("cpu"), cfg=s["cfg"],
                     mix=s["mix"], check=s["check"])
    with fixed_clock():
        ctx.load.measure(s["seconds"])
    ctx.load.release()
    numbers = core.judge(ctx, control=True)
    for name, limit in s["check"]["limits"].items():
        assert numbers[name] <= limit
        assert numbers["control." + name] > limit
