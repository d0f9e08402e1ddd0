"""The port's serving engine and launcher against the JAX package's, on the
CPU with shared fp32 parameters: greedy tokens must be identical."""
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import RuntimeCfg
from repro_torch.serve import Engine, Request, make_prefill, make_serve_step
from repro_torch.models import init_cache, lm
from torch_port_helpers import runtimes, shared_params

SMOKE = get("qwen3-14b").smoke
JSMOKE = jax_get("qwen3-14b").smoke


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, SMOKE.vocab, size=rng.randint(3, 7)) for _ in range(n)]


def _serve(engine, request_cls, prompts, max_new):
    for rid, pr in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=pr, max_new=max_new))
    done = engine.run(max_steps=64)
    return {r.rid: list(r.out) for r in done}


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_engine_tokens_equal_reference(impl):
    """3 requests over 2 slots: the third waits for a slot, then inherits a
    used cache row and the shared position, as in the JAX engine."""
    jparams, tparams = shared_params(SMOKE)
    jrt, trt = runtimes(impl=impl, jax_impl="naive")
    prompts = _prompts(3)
    want = _serve(JaxEngine(JSMOKE, jrt, jparams, batch_slots=2, kv_len=32),
                  JaxRequest, prompts, 4)
    eng = Engine(SMOKE, trt, tparams, batch_slots=2, kv_len=32, device="cpu")
    got = _serve(eng, Request, prompts, 4)
    assert sorted(got) == [0, 1, 2] and all(len(o) == 4 for o in got.values())
    assert got == want
    assert eng.steps == eng.cache["slots"][0]["attn"]["pos"] > 0


def test_same_prompt_same_output():
    _, tparams = shared_params(SMOKE)
    _, trt = runtimes(impl="cuda")
    prompt = _prompts(1, seed=3)[0]
    eng = Engine(SMOKE, trt, tparams, batch_slots=2, kv_len=32, device="cpu")
    got = _serve(eng, Request, [prompt, prompt.copy()], 5)
    assert got[0] == got[1] and len(got[0]) == 5
    assert all(0 <= t < SMOKE.vocab for t in got[0])


def test_engine_raises_past_kv_len():
    _, tparams = shared_params(SMOKE)
    _, trt = runtimes()
    eng = Engine(SMOKE, trt, tparams, batch_slots=1, kv_len=4, device="cpu")
    eng.submit(Request(rid=0, prompt=np.array([1, 2, 3]), max_new=8))
    with pytest.raises(ValueError, match="overflow"):
        eng.run(max_steps=16)


def test_prefill_and_serve_step_factories():
    _, tparams = shared_params(SMOKE)
    _, trt = runtimes(impl="cuda")
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, SMOKE.vocab, size=(2, 9)))
    last = make_prefill(SMOKE, trt)(tparams, tok)
    assert last.shape == (2, 1, SMOKE.vocab)
    full = lm.forward(tparams, tok, SMOKE, trt)
    assert torch.equal(last, full[:, -1:])
    cache = init_cache(SMOKE, trt, 2, 4, device="cpu")
    logits, cache = make_serve_step(SMOKE, trt)(tparams, cache, tok[:, :1])
    assert logits.shape == (2, 1, SMOKE.vocab)
    assert cache["slots"][0]["attn"]["pos"] == 1


def test_serve_launcher_on_cpu(capsys):
    done = serve_launcher.main(["--arch", "qwen3-14b", "--smoke", "--device",
                              "cpu", "--requests", "3", "--max-new", "3",
                              "--slots", "2", "--kv-len", "64"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "served 3/3" and len(done) == 3
    # the symbolic pre-flight line first, as the JAX package's launcher
    assert out[0].startswith("[serve] STAGE pre-flight: qwen3-smoke/decode")
    assert [l.split(":")[0] for l in out[1:-1]] == ["req 0", "req 1", "req 2"]


def test_serve_launcher_needs_device_request(monkeypatch):
    """Without a card the default device raises; it does not carry on on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_launcher.main(["--arch", "qwen3-14b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(SMOKE, RuntimeCfg(), {}, batch_slots=1, kv_len=4)


def test_serve_launcher_unported_arch(capsys):
    """whisper-medium, the last family to be ported, is served as the JAX
    package's launcher serves it: through the decode path, against
    cross-attention caches that nothing fills."""
    done = serve_launcher.main(["--arch", "whisper-medium", "--smoke",
                                "--device", "cpu", "--requests", "3",
                                "--max-new", "3", "--slots", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "served 3/3" and len(done) == 3
    assert all(len(r.out) == 3 for r in done)
