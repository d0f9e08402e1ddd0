"""The port's decoder LM against the JAX package's on the CPU: weights are
initialised by the JAX package and carried across with
``params_from_reference``; tokens come from numpy with a seed.

fp32 logits agree to 1e-4 (same arithmetic, other summation order, three
layers deep); the one bf16 case to 5e-2 (bf16 rounds at other places in the
two frameworks)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.core import MLASpec as JaxMLASpec
from repro.core import ModelSpec as JaxModelSpec
from repro.core import MoESpec as JaxMoESpec
from repro.core import SSMSpec as JaxSSMSpec
from repro.models import lm as JLM
from repro.models.common import pvalue
from repro_torch import MLASpec, ModelSpec, MoESpec, SSMSpec
from repro_torch.configs import ARCHS, PORTED, get
from repro_torch.models import (RuntimeCfg, init_cache, init_params, lm,
                                params_from_reference)
from torch_port_helpers import as_f32, runtimes, shared_params

ARCH = get("qwen3-14b")
SMOKE = ARCH.smoke
JSMOKE = jax_get("qwen3-14b").smoke
ALT_KW = dict(name="alt-window", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=96, vocab=128, d_head=16, window=4,
              window_pattern="alternate", attn_softcap=30.0,
              final_softcap=20.0, gated_ffn=False)


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s))


def _close(got, want, tol):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def test_configs_agree_with_reference():
    ref = jax_get("qwen3-14b")
    for mine, theirs in ((ARCH.spec, ref.spec), (ARCH.smoke, ref.smoke)):
        assert mine.__dict__ == theirs.__dict__
        assert mine.params() == theirs.params()
        assert mine.head_dim == theirs.head_dim
    assert ARCH.spec.d_model == 5120 and ARCH.spec.n_layers == 40
    assert set(PORTED) <= set(ARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("name", ARCHS)
def test_unserved_arch_resolves_to_reference(name):
    """Every arch resolves (the generator and the prover run them all) to
    the reference's specs, and the port serves every one: ``init_params``
    builds its smoke spec's tree (Mamba, an encoder, a vision prefix, MoE
    and MLA included) with the reference's keys, shapes and dtypes."""
    ref = jax_get(name)
    arch = get(name)
    for mine, theirs in ((arch.spec, ref.spec), (arch.smoke, ref.smoke)):
        assert mine.params() == theirs.params()
        assert mine.name == theirs.name
    assert arch.skip == ref.skip
    assert name in PORTED
    jrt, trt = runtimes("bfloat16")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        pvalue(JLM.init_params(ref.smoke, jrt,
                                               jax.random.PRNGKey(0))))
    params = init_params(arch.smoke, trt, device="cpu")
    assert params["slots"] or params["prefix"]
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
    assert got == want


_MLA = dict(kv_lora=16, q_lora=24, rope_dim=4, nope_dim=8, v_dim=8)
_MOE = dict(n_experts=4, top_k=2, d_expert=8)
_SSM = dict(d_state=4, expand=2, dt_rank=4)


@pytest.mark.parametrize("kw", [
    dict(block="mla", mla=_MLA), dict(block="mamba", ssm=_SSM),
    dict(attn_every=2, ssm=_SSM), dict(moe=_MOE),
    dict(encoder_layers=2, enc_seq=6), dict(vision_seq=4)],
    ids=["mla", "mamba", "hybrid", "moe", "encoder", "vision"])
def test_unported_family_raises(kw):
    """Every family is ported: ``init_params`` builds a tree equal in keys,
    shapes and dtypes to the reference's (Mamba's ``A_log`` fp32 at bf16),
    and fp32 logits of the reference's weights agree within 1e-4, with
    frames for the encoder and a vision prefix for the VLM."""
    def spec(cls, mla_cls, moe_cls, ssm_cls):
        extra = dict(kw)
        for key, nested in (("mla", mla_cls), ("moe", moe_cls),
                            ("ssm", ssm_cls)):
            if key in extra:
                extra[key] = nested(**extra[key])
        return cls(name="x", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                   d_ff=64, vocab=32, **extra)
    tspec = spec(ModelSpec, MLASpec, MoESpec, SSMSpec)
    jspec = spec(JaxModelSpec, JaxMLASpec, JaxMoESpec, JaxSSMSpec)
    jrt, trt = runtimes("bfloat16")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        pvalue(JLM.init_params(jspec, jrt,
                                               jax.random.PRNGKey(0))))
    mine = init_params(tspec, trt, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), mine)
    assert got == want

    jparams, tparams = shared_params(jspec)
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    rng = np.random.RandomState(5)
    tok = rng.randint(0, 32, size=(2, 7))
    extra = {}
    if tspec.encoder_layers:
        extra["frames"] = rng.standard_normal((2, tspec.enc_seq, 32))
    if tspec.vision_seq:
        extra["vision"] = rng.standard_normal((2, tspec.vision_seq, 32))
    want = JLM.forward(jparams, jnp.asarray(tok), jspec, jrt,
                       **{k: jnp.asarray(v, jnp.float32)
                          for k, v in extra.items()})
    got = lm.forward(tparams, torch.from_numpy(tok), tspec, trt,
                     **{k: torch.from_numpy(v).float()
                        for k, v in extra.items()})
    assert got.shape == (2, 7 + tspec.vision_seq, 32)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(dtype):
    """Same keys, nesting, shapes and dtypes as the JAX package's tree; 1-D
    leaves are ones; matrices have the fan-in scale."""
    jparams, _ = shared_params(SMOKE, dtype)
    _, trt = runtimes(dtype)
    gen = torch.Generator(device="cpu").manual_seed(3)
    mine = init_params(SMOKE, trt, gen, device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        pvalue(jparams))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), mine)
    assert got == want
    attn = mine["slots"][0]["attn"]
    assert torch.all(attn["ln"] == 1) and torch.all(mine["ln_f"] == 1)
    std = attn["w_q"].float().std().item()
    assert abs(std - SMOKE.d_model ** -0.5) < 0.1 * SMOKE.d_model ** -0.5
    again = init_params(SMOKE, trt, torch.Generator().manual_seed(3),
                        device="cpu")
    assert torch.equal(again["lm_head"], mine["lm_head"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_round_trip(dtype):
    """Every leaf arrives bit for bit, bf16 leaves as ml_dtypes arrays."""
    jparams, tparams = shared_params(SMOKE, dtype)
    flat_j = jax.tree.leaves(pvalue(jparams))
    flat_t = jax.tree.leaves(tparams)
    assert len(flat_j) == len(flat_t) > 10
    for a, t in zip(flat_j, flat_t):
        a = np.asarray(a)
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == a.shape
        if dtype == "bfloat16":
            assert a.dtype == ml_dtypes.bfloat16
            back = t.view(torch.uint16).numpy()
            assert np.array_equal(back, a.view(np.uint16))
        else:
            assert np.array_equal(t.numpy(), a)


def test_params_from_reference_casts_on_request():
    tree = {"w": np.ones((2, 3), np.float32), "idx": np.arange(3)}
    out = params_from_reference(tree, device="cpu", dtype="bfloat16")
    assert out["w"].dtype == torch.bfloat16 and out["idx"].dtype == torch.int64


@pytest.mark.parametrize("impl,jax_impl", [
    ("naive", "naive"), ("naive", "pallas"), ("cuda", "naive"),
    ("cuda", "pallas")])
def test_forward_logits_fp32(impl, jax_impl):
    """'cuda' (the kernel's plain version on the CPU) against the JAX
    package's naive core and its Pallas kernel in interpret mode."""
    jparams, tparams = shared_params(SMOKE)
    jrt, trt = runtimes(impl=impl, jax_impl=jax_impl)
    tok = _tokens(0, 2, 24, SMOKE.vocab)
    want = JLM.forward(jparams, jnp.asarray(tok), JSMOKE, jrt)
    got = lm.forward(tparams, torch.from_numpy(tok), SMOKE, trt)
    assert got.shape == (2, 24, SMOKE.vocab)
    _close(got, want, 1e-4)


def test_forward_logits_bf16():
    jparams, tparams = shared_params(SMOKE, "bfloat16")
    jrt, trt = runtimes("bfloat16", impl="cuda", jax_impl="naive")
    tok = _tokens(1, 2, 16, SMOKE.vocab)
    want = JLM.forward(jparams, jnp.asarray(tok), JSMOKE, jrt)
    got = lm.forward(tparams, torch.from_numpy(tok), SMOKE, trt)
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_decode_steps_fp32(impl):
    """Six decode steps against the JAX 'naive' path (its 'pallas' decode
    does not run: q_offset is static there)."""
    jparams, tparams = shared_params(SMOKE)
    jrt, trt = runtimes(impl=impl, jax_impl="naive")
    jcache = JLM.init_cache(JSMOKE, jrt, 2, 8)
    tcache = init_cache(SMOKE, trt, 2, 8, device="cpu")
    assert tuple(tcache["slots"][0]["attn"]["k"].shape) == \
        jcache["slots"][0]["attn"]["k"].shape
    for step in range(6):
        tok = _tokens(10 + step, 2, 1, SMOKE.vocab)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(tok),
                                       JSMOKE, jrt)
        got, tcache = lm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     SMOKE, trt)
        _close(got, want, 1e-4)
    assert tcache["slots"][0]["attn"]["pos"] == 6
    _close(tcache["slots"][0]["attn"]["k"], jcache["slots"][0]["attn"]["k"],
           1e-4)


def test_decode_matches_forward():
    """Feeding a sequence token by token gives the prefill's logits."""
    _, tparams = shared_params(SMOKE)
    _, trt = runtimes(impl="cuda")
    tok = torch.from_numpy(_tokens(2, 2, 7, SMOKE.vocab))
    want = lm.forward(tparams, tok, SMOKE, trt)
    cache = init_cache(SMOKE, trt, 2, 8, device="cpu")
    for i in range(7):
        got, cache = lm.decode_step(tparams, cache, tok[:, i:i + 1], SMOKE, trt)
        _close(got[:, 0], want[:, i], 1e-4)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_alternating_window_period_two(impl):
    """Local/global alternation (period 2), softcaps and the gelu FFN:
    prefill logits and six decode steps (ring cache on the local slot)."""
    jspec, tspec = JaxModelSpec(**ALT_KW), ModelSpec(**ALT_KW)
    assert lm.layer_pattern(tspec) == JLM.layer_pattern(jspec) == (0, 2)
    jparams, tparams = shared_params(tspec)
    jrt, trt = runtimes(impl=impl, jax_impl="naive")
    tok = _tokens(3, 2, 12, tspec.vocab)
    _close(lm.forward(tparams, torch.from_numpy(tok), tspec, trt),
           JLM.forward(jparams, jnp.asarray(tok), jspec, jrt), 1e-4)
    jcache = JLM.init_cache(jspec, jrt, 2, 8)
    tcache = init_cache(tspec, trt, 2, 8, device="cpu")
    assert tcache["slots"][0]["attn"]["k"].shape[2] == 4     # the window
    for step in range(6):
        tok = _tokens(20 + step, 2, 1, tspec.vocab)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(tok),
                                       jspec, jrt)
        got, tcache = lm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     tspec, trt)
        _close(got, want, 1e-4)


def test_entry_points_need_a_device_request(monkeypatch):
    """Without a card and without device='cpu' the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt = RuntimeCfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(SMOKE, rt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(SMOKE, rt, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference({"w": np.zeros(2, np.float32)})


def test_odd_alternating_stack_is_unstacked():
    """Three alternating layers do not repeat with period 2: every layer is
    a prefix layer of its own, in both packages.  The JAX package's
    ``forward`` does not run such a stack (it scans over the empty slot
    list), so decode is held against the JAX decode and the port's prefill
    against the port's own decode."""
    kw = {**ALT_KW, "n_layers": 3}
    jspec, tspec = JaxModelSpec(**kw), ModelSpec(**kw)
    assert lm.layer_pattern(tspec) == JLM.layer_pattern(jspec) == (3, 1)
    jparams, tparams = shared_params(tspec)
    assert len(tparams["prefix"]) == 3 and tparams["slots"] == [{}]
    jrt, trt = runtimes(impl="cuda", jax_impl="naive")
    tok = _tokens(4, 2, 6, tspec.vocab)
    prefill = lm.forward(tparams, torch.from_numpy(tok), tspec, trt)
    jcache = JLM.init_cache(jspec, jrt, 2, 8)
    tcache = init_cache(tspec, trt, 2, 8, device="cpu")
    for i in range(6):
        want, jcache = JLM.decode_step(jparams, jcache,
                                       jnp.asarray(tok[:, i:i + 1]), jspec, jrt)
        got, tcache = lm.decode_step(tparams, tcache,
                                     torch.from_numpy(tok[:, i:i + 1]), tspec,
                                     trt)
        _close(got, want, 1e-4)
        _close(got[:, 0], prefill[:, i], 1e-4)
    mine = init_params(tspec, trt, device="cpu")
    assert len(mine["prefix"]) == 3 and mine["slots"] == [{}]
