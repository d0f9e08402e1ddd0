"""The port's encoder and cross-attention (whisper) against the JAX
package's on the CPU: both cross branches of ``gqa_attention``, the encoder
``_run_encoder``, and two behaviours of the reference the port mirrors.

Inputs come from numpy with a seed; weights are drawn by the JAX package and
carried across.  fp32, within 1e-5 (layers) and 1e-4 (logits).  The port's
attention runs through the kernel's wrapper (``"cuda"``: its plain version
on the CPU), the reference's through its ``"naive"`` core."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.common import Initializer as JaxInitializer
from repro.models.common import pvalue
from repro.serve.engine import make_prefill as jax_make_prefill
from repro_torch.models import init_cache, layers as L, lm
from repro_torch.models import params_from_reference
from repro_torch.serve import Engine, Request
from torch_port_helpers import (as_f32, port_spec, runtimes, shared_params,
                                to_jax, to_torch)

JSPEC = jax_get("whisper-medium").smoke
TSPEC = port_spec(JSPEC)
H, T = JSPEC.d_model, JSPEC.enc_seq
NKV, DH = JSPEC.n_kv_heads, JSPEC.head_dim


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _gqa_params(seed=0):
    ini = JaxInitializer(jax.random.PRNGKey(seed), "float32")
    jp = JL.init_gqa(ini, JSPEC, "x_")
    return jp, params_from_reference(jax.tree.map(np.asarray, pvalue(jp)),
                                     device="cpu")


def test_cross_attention_from_encoder_output():
    """The prefill branch: k and v from the encoder's output, no rope, no
    mask (a query row sees all T frames, Sq != T); it returns them as the
    cross cache."""
    jp, tp = _gqa_params()
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 9, H))
    enc = rng.standard_normal((2, T, H))
    want, wc = JL.gqa_attention(jp, to_jax(x), JSPEC, jrt, None,
                                cross_kv=to_jax(enc))
    got, tc = L.gqa_attention(tp, to_torch(x), TSPEC, trt,
                              cross_kv=to_torch(enc))
    _close(got, want)
    assert set(tc) == set(wc) == {"k", "v"}
    assert tuple(tc["k"].shape) == (2, T, NKV, DH)
    for k in ("k", "v"):
        _close(tc[k], wc[k])


def test_cached_cross_attention():
    """The decode branch: a cache without ``pos`` (random k and v here),
    unmasked, handed back unchanged (the same tensors, not written)."""
    jp, tp = _gqa_params(1)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    rng = np.random.RandomState(1)
    x = rng.standard_normal((3, 1, H))
    k, v = (rng.standard_normal((3, T, NKV, DH)) for _ in range(2))
    want, wc = JL.gqa_attention(jp, to_jax(x), JSPEC, jrt, None,
                                cache={"k": to_jax(k), "v": to_jax(v)})
    cache = {"k": to_torch(k), "v": to_torch(v)}
    got, tc = L.gqa_attention(tp, to_torch(x), TSPEC, trt, cache=cache)
    _close(got, want)
    assert tc is cache and np.array_equal(as_f32(tc["k"]), k.astype("f4"))


def test_run_encoder():
    jparams, tparams = shared_params(JSPEC)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    frames = np.random.RandomState(2).standard_normal((2, T, H))
    want = JLM._run_encoder(jparams, to_jax(frames), JSPEC, jrt, None)
    got = lm._run_encoder(tparams, to_torch(frames), TSPEC, trt)
    assert got.shape == (2, T, H)
    _close(got, want)


def test_forward_needs_frames():
    """Finding 2: the reference's prefill cannot run whisper without frames
    (``_run_encoder`` calls ``None.astype``; its engine's ``make_prefill``
    passes none).  The port's forward raises a ValueError naming them."""
    jparams, tparams = shared_params(JSPEC)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    tok = np.random.RandomState(3).randint(0, JSPEC.vocab, size=(2, 5))
    with pytest.raises(AttributeError, match="astype"):
        jax_make_prefill(JSPEC, jrt)(jparams, jnp.asarray(tok))
    with pytest.raises(ValueError, match="frames"):
        lm.forward(tparams, torch.from_numpy(tok), TSPEC, trt)


def test_served_decode_does_not_see_the_frames():
    """Finding 1: nothing fills the cross caches, in either package, so a
    served whisper decodes against zero keys and values: every layer's
    cross-attention adds exactly 0 and the audio never reaches a token.
    The same greedy tokens as the reference's engine; the cross caches are
    still zeros after the run; and the logits of a decode step do not move
    when every cross-attention's weights are replaced, while with a filled
    (random) cross cache they do."""
    jparams, tparams = shared_params(JSPEC)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    jcache = JLM.init_cache(JSPEC, jrt, 2, 16)
    tcache = init_cache(TSPEC, trt, 2, 16, device="cpu")
    cross = tcache["slots"][0]["cross"]
    assert tuple(cross["k"].shape) == (JSPEC.n_layers, 2, T, NKV, DH)
    assert not as_f32(jcache["slots"][0]["cross"]["k"]).any()
    assert not cross["k"].any() and not cross["v"].any()

    from repro.serve.engine import Engine as JaxEngine
    from repro.serve.engine import Request as JaxRequest
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, JSPEC.vocab, size=rng.randint(3, 7))
               for _ in range(3)]

    def serve(engine, request_cls):
        for rid, pr in enumerate(prompts):
            engine.submit(request_cls(rid=rid, prompt=pr, max_new=4))
        return {r.rid: list(r.out) for r in engine.run(max_steps=64)}

    want = serve(JaxEngine(JSPEC, jrt, jparams, batch_slots=2, kv_len=32),
                 JaxRequest)
    eng = Engine(TSPEC, trt, tparams, batch_slots=2, kv_len=32, device="cpu")
    got = serve(eng, Request)
    assert sorted(got) == [0, 1, 2] and got == want
    assert not eng.cache["slots"][0]["cross"]["k"].any()

    tok = torch.from_numpy(rng.randint(0, JSPEC.vocab, size=(2, 1)))
    other = dict(tparams, cross={
        k: torch.from_numpy(rng.standard_normal(tuple(t.shape))).float()
        for k, t in tparams["cross"].items()})

    def step(params, fill=None):
        cache = init_cache(TSPEC, trt, 2, 16, device="cpu")
        if fill is not None:
            for k in ("k", "v"):
                cache["slots"][0]["cross"][k].copy_(fill)
        return lm.decode_step(params, cache, tok, TSPEC, trt)[0]

    base = step(tparams)
    assert torch.equal(step(other), base)
    filled = torch.from_numpy(rng.standard_normal(tuple(cross["k"].shape)))
    assert not torch.allclose(step(tparams, filled), base, atol=1e-3)
