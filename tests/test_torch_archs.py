"""The families served beside qwen3 and rwkv6 (granite MQA, minitron's gelu
FFN, gemma2's alternating windows and softcaps, deepseek-moe's MoE,
deepseek-v2's MLA + MoE, jamba's Mamba + attention + MoE hybrid, whisper's
encoder and cross-attention, internvl2's vision prefix) against the JAX
package on the CPU, at their smoke specs: the parameter tree, prefill logits
(with frames / a vision prefix), decode steps and the serving engine's
greedy tokens.

Weights are initialised by the JAX package and carried across; tokens come
from numpy with a seed.  fp32, logits within 1e-4 (the same arithmetic in
another order of sums, three or four layers deep).  The port's attention
runs through the kernel's wrapper (``"cuda"``: its plain version on the
CPU), the reference's through its ``"naive"`` core."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.core import ModelSpec as JaxModelSpec
from repro.models import lm as JLM
from repro.models.common import pvalue
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import PORTED, get
from repro_torch.models import init_cache, init_params, lm
from repro_torch.serve import Engine, Request
from torch_port_helpers import as_f32, port_spec, runtimes, shared_params

FAMILIES = ("granite-34b", "minitron-8b", "gemma2-27b", "deepseek-moe-16b",
            "deepseek-v2-236b", "jamba-v0.1-52b", "whisper-medium",
            "internvl2-26b")
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s))


def _tensor_shapes(tree):
    """The shapes of a cache's tensors, ``pos`` left out."""
    if isinstance(tree, dict):
        return {k: _tensor_shapes(v) for k, v in tree.items() if k != "pos"}
    if isinstance(tree, (list, tuple)):
        return [_tensor_shapes(v) for v in tree]
    return tuple(tree.shape)


def _specs(name):
    jspec = jax_get(name).smoke
    return jspec, get(name).smoke


def _prefix_inputs(spec, seed):
    """Whisper's frame embeddings [2, enc_seq, H] and internvl2's patch
    embeddings [2, vision_seq, H], from numpy with a seed: {name: array}."""
    rng = np.random.RandomState(seed)
    extra = {}
    if spec.encoder_layers:
        extra["frames"] = rng.standard_normal((2, spec.enc_seq, spec.d_model))
    if spec.vision_seq:
        extra["vision"] = rng.standard_normal((2, spec.vision_seq,
                                               spec.d_model))
    return extra


def test_the_five_are_served():
    """Every arch is served: the families here, qwen3 and rwkv6."""
    assert set(FAMILIES) <= set(PORTED) and len(PORTED) == 10
    assert {"qwen3-14b", "rwkv6-7b"} | set(FAMILIES) == set(PORTED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_param_tree_matches_reference(name, dtype):
    """The port's own init: the same keys, nesting, shapes and dtypes as
    the reference's tree (the MoE router and Mamba's ``A_log`` fp32 at
    either dtype; whisper's encoder, ``ln_enc`` and per-layer ``cross``),
    and the same layer pattern (deepseek's dense first layer as the prefix,
    jamba's period of 8)."""
    jspec, tspec = _specs(name)
    jrt, trt = runtimes(dtype)
    jparams = JLM.init_params(jspec, jrt, jax.random.PRNGKey(0))
    mine = init_params(tspec, trt, torch.Generator().manual_seed(0),
                       device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        pvalue(jparams))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), mine)
    assert got == want
    assert lm.layer_pattern(tspec) == JLM.layer_pattern(jspec)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits(name):
    jspec, tspec = _specs(name)
    jparams, tparams = shared_params(jspec)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    tok = _tokens(0, 2, 20, tspec.vocab)
    extra = _prefix_inputs(tspec, 1)
    want = JLM.forward(jparams, jnp.asarray(tok), jspec, jrt,
                       **{k: jnp.asarray(v, jnp.float32)
                          for k, v in extra.items()})
    got = lm.forward(tparams, torch.from_numpy(tok), tspec, trt,
                     **{k: torch.from_numpy(v).float()
                        for k, v in extra.items()})
    assert got.shape == (2, tspec.vision_seq + 20, tspec.vocab)
    _close(got, want)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps(name):
    """Six single-token steps from an empty 16-entry cache; gemma2's local
    layers keep a ring no longer than the window; whisper's cross caches
    are zeros in both packages."""
    jspec, tspec = _specs(name)
    jparams, tparams = shared_params(jspec)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    jcache = JLM.init_cache(jspec, jrt, 2, 16)
    tcache = init_cache(tspec, trt, 2, 16, device="cpu")
    # the same cache tensors (``pos`` is an [n_rep] array in the reference's
    # stacked caches and one integer in the port's)
    assert _tensor_shapes(jcache) == _tensor_shapes(tcache)
    for step in range(6):
        tok = _tokens(10 + step, 2, 1, tspec.vocab)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(tok),
                                       jspec, jrt)
        got, tcache = lm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     tspec, trt)
        _close(got, want)


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_tokens_equal_reference(name):
    """3 requests over 2 slots through both engines: the same greedy tokens
    (MoE decode steps route the two slots' tokens together, at capacity
    C = ceil(2 K / E x 1.25), as the reference's)."""
    jspec, tspec = _specs(name)
    jparams, tparams = shared_params(jspec)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, tspec.vocab, size=rng.randint(3, 7))
               for _ in range(3)]

    def serve(engine, request_cls):
        for rid, pr in enumerate(prompts):
            engine.submit(request_cls(rid=rid, prompt=pr, max_new=4))
        return {r.rid: list(r.out) for r in engine.run(max_steps=64)}

    want = serve(JaxEngine(jspec, jrt, jparams, batch_slots=2, kv_len=32),
                 JaxRequest)
    got = serve(Engine(tspec, trt, tparams, batch_slots=2, kv_len=32,
                       device="cpu"), Request)
    assert sorted(got) == [0, 1, 2] and got == want


def test_gemma2_ring_cache_at_the_published_window():
    """gemma2's local layers at its published window of 4096 (smoke widths)
    with a cache shorter than the window, as the served engine's kv_len 2048:
    the ring cache (shift, append, attend to the filled tail with no causal
    mask) through the kernel's wrapper, against the reference's ring
    branch, over eight steps."""
    jspec0 = jax_get("gemma2-27b")
    assert jspec0.spec.window == 4096
    kw = {f: getattr(jspec0.smoke, f) for f in jspec0.smoke.__dataclass_fields__}
    kw["window"] = jspec0.spec.window
    jspec = JaxModelSpec(**kw)
    tspec = port_spec(jspec)
    jparams, tparams = shared_params(jspec)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    jcache = JLM.init_cache(jspec, jrt, 2, 12)
    tcache = init_cache(tspec, trt, 2, 12, device="cpu")
    local = tcache["slots"][0]["attn"]["k"]
    assert lm._slot_kind(tspec, 0)["window"] == 4096 and local.shape[2] == 12
    for step in range(8):
        tok = _tokens(30 + step, 2, 1, tspec.vocab)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(tok),
                                       jspec, jrt)
        got, tcache = lm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     tspec, trt)
        _close(got, want)
    _close(tcache["slots"][0]["attn"]["k"], jcache["slots"][0]["attn"]["k"])


def _jamba16():
    """jamba's smoke spec at 16 layers: two repeats of the period of 8."""
    jspec0 = jax_get("jamba-v0.1-52b").smoke
    kw = {f: getattr(jspec0, f) for f in jspec0.__dataclass_fields__}
    kw.update(n_layers=16, name="jamba-smoke-16")
    jspec = JaxModelSpec(**kw)
    return jspec, port_spec(jspec)


def test_jamba_decode_runs_slot_by_slot():
    """At n_rep 2 the reference's decode runs each slot of the period over
    both repeats before the next slot (layers 0, 8, 1, 9, ...), while its
    forward runs layer order.  The port's decode steps equal the
    reference's, and its decode of a prompt differs from its own prefill
    logits, as the reference's does."""
    jspec, tspec = _jamba16()
    assert lm.layer_pattern(tspec) == JLM.layer_pattern(jspec) == (0, 8)
    assert lm._n_rep(tspec) == 2
    jparams, tparams = shared_params(jspec)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    jcache = JLM.init_cache(jspec, jrt, 2, 16)
    tcache = init_cache(tspec, trt, 2, 16, device="cpu")
    tok = _tokens(40, 2, 5, tspec.vocab)
    for step in range(5):
        want, jcache = JLM.decode_step(jparams, jcache,
                                       jnp.asarray(tok[:, step:step + 1]),
                                       jspec, jrt)
        got, tcache = lm.decode_step(tparams, tcache,
                                     torch.from_numpy(tok[:, step:step + 1]),
                                     tspec, trt)
        _close(got, want)
    prefill = lm.forward(tparams, torch.from_numpy(tok), tspec, trt)
    jprefill = JLM.forward(jparams, jnp.asarray(tok), jspec, jrt)
    _close(prefill, jprefill)
    assert not np.allclose(as_f32(got[:, 0]), as_f32(prefill[:, -1]),
                           atol=1e-2)
