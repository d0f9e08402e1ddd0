"""The port's RWKV6 slice against the JAX package's, on the CPU: the wkv6
plain version and wrappers, the layer, the LM, the engine and the launcher.
Inputs and weights come from numpy with a seed (weights: the JAX package's
initializer, carried across with ``params_from_reference``).

Decays are drawn two ways.  Mild: ``dec ~ U(-2, 0.5)`` as in the reference's
own wkv6 tests, where no decay reaches the ``-80/C`` floor of the chunked
form.  Strong: ``dec ~ N(0, 1)`` as the model's random weights draw it, where
about a fifth of the decays are below the floor and the chunked function
departs from the exact recurrence.

Tolerances: 1e-4 (absolute and relative) for fp32 scans and logits (the same
arithmetic in another summation order; the chunked form multiplies factors up
to e^{+-80}), 1e-5 for a layer in fp32, 5e-2 in bf16 (bf16 rounds at other
places in the two frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.configs import get as jax_get
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv6_bhsd as jax_wkv6_bhsd
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.common import Initializer as JaxInitializer
from repro.models.common import pvalue
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as W
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (RuntimeCfg, init_cache, init_params, layers,
                                lm, params_from_reference)
from repro_torch.serve import Engine, Request
from torch_port_helpers import as_f32, runtimes, shared_params, to_jax, to_torch

ARCH = get("rwkv6-7b")
SMOKE = ARCH.smoke
JSMOKE = jax_get("rwkv6-7b").smoke
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _wkv_inputs(seed, b, h, s, d, decays="mild", state=False):
    """r/k/v/w [B,H,S,D], u [H,D], state0 [B,H,D,D] as float32 numpy."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    if decays == "mild":
        dec = rng.uniform(-2.0, 0.5, (b, h, s, d))
    else:
        dec = rng.standard_normal((b, h, s, d))
    w = np.exp(-np.exp(dec)).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.5 if state
          else np.zeros((b, h, d, d))).astype(np.float32)
    return r, k, v, w, u, s0


def _model_layout(a):
    """[B,H,S,D] numpy -> [B,S,H,D] torch."""
    return to_torch(a.transpose(0, 2, 1, 3))


REF_SHAPES = [(1, 1, 64, 32, 32), (2, 2, 128, 64, 32), (1, 3, 96, 48, 32)]


# ---------------------------------------------------------------------------
# the scan: plain version and wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decays", ["mild", "strong"])
@pytest.mark.parametrize("b,h,s,d,chunk", REF_SHAPES)
def test_plain_and_wrappers_vs_pallas_interpret(b, h, s, d, chunk, decays):
    """The reference's wkv6 shapes: the port's plain version, ``ops.wkv6``
    and ``wkv6_bhsd`` on the CPU against the Pallas kernel in interpret
    mode, with mild decays and with strong ones where the floor acts."""
    r, k, v, w, u, s0 = _wkv_inputs(3, b, h, s, d, decays)
    want_o, want_s = jax_wkv6_bhsd(*(to_jax(a) for a in (r, k, v, w, u, s0)),
                                   chunk=chunk, interpret=True)
    got_o, got_s = W.wkv6_bhsd(*(to_torch(a) for a in (r, k, v, w, u, s0)),
                               chunk=chunk)
    _close(got_o, want_o)
    _close(got_s, want_s)
    ml = [_model_layout(a) for a in (r, k, v, w)]
    plain_o, plain_s = W.wkv6_plain(*ml, to_torch(u), to_torch(s0),
                                    chunk=chunk)
    ops_o, ops_s = ops.wkv6(*ml, to_torch(u), to_torch(s0), chunk=chunk)
    assert torch.equal(ops_o, plain_o) and torch.equal(ops_s, plain_s)
    _close(plain_o.transpose(1, 2), want_o)
    _close(plain_s, want_s)


def test_model_layout_wrapper_vs_jax_ops():
    """ops.wkv6 in model layout against the JAX wrapper of the same name,
    with a non-zero state and strong decays."""
    r, k, v, w, u, s0 = _wkv_inputs(5, 2, 3, 64, 32, "strong", state=True)
    ml = [a.transpose(0, 2, 1, 3) for a in (r, k, v, w)]
    want_o, want_s = jops.wkv6(*(to_jax(a) for a in ml), to_jax(u),
                               to_jax(s0), chunk=32, interpret=True)
    got_o, got_s = ops.wkv6(*(to_torch(a) for a in ml), to_torch(u),
                            to_torch(s0), chunk=32)
    assert got_o.shape == (2, 64, 3, 32) and got_o.dtype == torch.float32
    _close(got_o, want_o)
    _close(got_s, want_s)


@pytest.mark.parametrize("b,h,s,d,chunk", REF_SHAPES)
def test_ref_wkv_vs_jax_ref(b, h, s, d, chunk):
    """The port's exact-recurrence oracle against the JAX package's."""
    args = _wkv_inputs(4, b, h, s, d, "strong", state=True)
    got = ref.ref_wkv(*(to_torch(a) for a in args))
    want = jref.ref_wkv(*(to_jax(a) for a in args))
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)


@pytest.mark.parametrize("decays", ["mild", "strong"])
@pytest.mark.parametrize("b,h,s,d,chunk", REF_SHAPES)
def test_plain_vs_exact_recurrence(b, h, s, d, chunk, decays):
    """Mild decays: the chunked function is the exact recurrence (1e-4).
    Strong decays: it is not, by more than 1e-2 — the floor is part of the
    function, and the port keeps it."""
    r, k, v, w, u, s0 = _wkv_inputs(6, b, h, s, d, decays, state=True)
    tt = [to_torch(a) for a in (r, k, v, w, u, s0)]
    exact_o, exact_s = ref.ref_wkv(*tt)
    got_o, got_s = W.wkv6_bhsd(*tt, chunk=chunk)
    if decays == "mild":
        _close(got_o, exact_o)
        _close(got_s, exact_s)
    else:
        assert (got_o - exact_o).abs().max() > 1e-2
        _close(got_s, exact_s)     # the carried state uses the true decay


def test_decode_step_is_exact():
    """C = 1 (a decode step) has no intra-chunk pair: the exact recurrence,
    whatever the decays."""
    r, k, v, w, u, s0 = _wkv_inputs(7, 3, 4, 1, 64, "strong", state=True)
    tt = [to_torch(a) for a in (r, k, v, w, u, s0)]
    exact_o, exact_s = ref.ref_wkv(*tt)
    got_o, got_s = W.wkv6_bhsd(*tt, chunk=32)
    _close(got_o, exact_o, 1e-5)
    _close(got_s, exact_s, 1e-5)


@pytest.mark.parametrize("s,chunk", [(40, 40), (64, 32), (128, 32)])
def test_state_carry_and_in_place(s, chunk):
    """Two calls with the state carried (the second writing its state over
    its input, as a decode cache) == one call over the whole sequence where
    the chunk boundaries are the same; the second call == the plain version
    on the carried state in every case."""
    r, k, v, w, u, s0 = _wkv_inputs(8, 2, 2, s, 32, "strong", state=True)
    ml = [_model_layout(a) for a in (r, k, v, w)]
    tu, ts0 = to_torch(u), to_torch(s0)
    full_o, full_s = ops.wkv6(*ml, tu, ts0, chunk=chunk)
    half = s // 2
    part = min(chunk, half)
    o1, st1 = ops.wkv6(*(t[:, :half] for t in ml), tu, ts0, chunk=part)
    cache = st1.clone()
    o2, st2 = ops.wkv6(*(t[:, half:] for t in ml), tu, cache, chunk=part,
                       state_out=cache)
    assert st2 is cache
    if chunk < s:                                   # same chunk boundaries
        _close(torch.cat([o1, o2], dim=1), full_o)
        _close(st2, full_s)
    want = W.wkv6_plain(*(t[:, half:] for t in ml), tu, st1, chunk=part)
    assert torch.equal(o2, want[0]) and torch.equal(st2, want[1])
    assert torch.equal(ts0, to_torch(s0))           # state0 left alone


@given(st.integers(1, 3), st.integers(1, 3),
       st.sampled_from([32, 40, 64]), st.sampled_from([16, 32, 48]),
       st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_wkv6_property(b, h, s, d, seed):
    """Random small shapes, strong decays and a non-zero state: the port's
    wrapper against the Pallas kernel in interpret mode, with the JAX
    layer's chunk rule (one chunk when 32 does not divide S)."""
    _check_property_case(b, h, s, d, seed)


@pytest.mark.parametrize("b,h,s,d,seed", [(2, 3, 40, 48, 21111)])
def test_wkv6_property_found_case(b, h, s, d, seed):
    """A case the property test found, held at its limit: strong decays in
    one chunk of 40.  The plain version's prefix sums of the log-decays are
    products with a lower-triangular ones matrix, as the Pallas kernel's
    are; a sequential ``cumsum`` rounded them elsewhere, and the factors up
    to e^{+-80} put one output 1.09e-4 from the kernel's (limit 1.08e-4)."""
    _check_property_case(b, h, s, d, seed)


def _check_property_case(b, h, s, d, seed):
    chunk = 32 if s % 32 == 0 else s
    args = _wkv_inputs(seed % 10000, b, h, s, d, "strong", state=True)
    want_o, want_s = jax_wkv6_bhsd(*(to_jax(a) for a in args), chunk=chunk,
                                   interpret=True)
    got_o, got_s = W.wkv6_bhsd(*(to_torch(a) for a in args), chunk=chunk)
    _close(got_o, want_o)
    _close(got_s, want_s)


@pytest.mark.parametrize("bad", ["chunk", "dtype", "device", "head_dim",
                                 "state_shape", "u_shape"])
def test_wrapper_refuses(bad):
    """A chunk that does not divide S, a device that is neither the CPU nor
    the card and shapes that do not fit are refused.  A k of another dtype
    than r and v, and a head dim that is no kernel instance, refused
    before, now give the reference's result (the JAX wrapper, Pallas in
    interpret mode, casts every input on load and pads any D)."""
    rng = np.random.RandomState(21)
    d = 8 if bad == "head_dim" else 16
    r, k, v = (to_torch(rng.standard_normal((1, 8, 2, d)).astype(np.float32))
               for _ in range(3))
    w = to_torch(rng.uniform(0.2, 0.9, (1, 8, 2, d)).astype(np.float32))
    u = to_torch(rng.standard_normal((2, d)).astype(np.float32))
    s0 = to_torch(rng.standard_normal((1, 2, d, d)).astype(np.float32))
    chunk = 4
    if bad in ("dtype", "head_dim"):
        if bad == "dtype":
            k = k.bfloat16()
        jr, jk, jv, jw = (to_jax(t.float().numpy(), str(t.dtype)[6:])
                          for t in (r, k, v, w))
        want_o, want_s = jops.wkv6(jr, jk, jv, jw, to_jax(u.numpy()),
                                   to_jax(s0.numpy()), chunk=chunk,
                                   interpret=True)
        got_o, got_s = ops.wkv6(r, k, v, w, u, s0, chunk=chunk)
        assert got_o.shape == r.shape and got_o.dtype == torch.float32
        _close(got_o, want_o)
        _close(got_s, want_s)
        return
    if bad == "chunk":
        chunk = 3                                    # 3 does not divide 8
    elif bad == "device":                            # neither cpu nor cuda
        r, k, v, w, u, s0 = (t.to("meta") for t in (r, k, v, w, u, s0))
    elif bad == "state_shape":
        s0 = torch.zeros(1, 2, 16, 8)
    elif bad == "u_shape":
        u = torch.zeros(3, 16)
    with pytest.raises((TypeError, ValueError)):
        ops.wkv6(r, k, v, w, u, s0, chunk=chunk)


def test_bhsd_chunk_must_divide():
    """As the reference asserts: the chunk (capped at S) divides S."""
    args = [to_torch(a) for a in _wkv_inputs(9, 1, 1, 48, 16)]
    with pytest.raises(ValueError, match="chunks"):
        W.wkv6_bhsd(*args, chunk=32)
    out, _ = W.wkv6_bhsd(*args, chunk=64)             # min(64, 48) = 48
    assert out.shape == (1, 1, 48, 16)


def test_launch_count_untouched_on_cpu():
    before = W.launches
    ops.wkv6(*(torch.zeros(1, 2, 1, 16) for _ in range(4)),
             torch.zeros(1, 16), torch.zeros(1, 1, 16, 16), chunk=2)
    assert W.launches == before


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

LAYER_KW = dict(name="t", n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                d_ff=96, vocab=64, d_head=32, block="rwkv6",
                rwkv_decay_rank=8)


def _layer_params(dtype, seed=0):
    from repro.core import ModelSpec as JaxModelSpec
    from repro_torch import ModelSpec
    jspec, tspec = JaxModelSpec(**LAYER_KW), ModelSpec(**LAYER_KW)
    jp = JL.init_rwkv6(JaxInitializer(jax.random.PRNGKey(seed), dtype), jspec)
    tp = params_from_reference(jax.tree.map(np.asarray, pvalue(jp)),
                               device="cpu")
    return jspec, tspec, jp, tp


def _x(seed, b, s, dtype):
    a = np.random.RandomState(seed).standard_normal(
        (b, s, LAYER_KW["d_model"])).astype(np.float32)
    return to_jax(a, dtype), to_torch(a, dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("s", [64, 40])
def test_rwkv6_layer_prefill(s, dtype, tol):
    """S = 64: two chunks of 32; S = 40: one chunk of 40."""
    jspec, tspec, jp, tp = _layer_params(dtype)
    jrt, trt = runtimes(dtype)
    jx, tx = _x(1, 2, s, dtype)
    want, _ = JL.rwkv6_layer(jp, jx, jspec, jrt, None)
    got, cache = layers.rwkv6_layer(tp, tx, tspec, trt)
    assert cache is None and got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_rwkv6_layer_decode_with_cache(dtype, tol):
    """Five single-token steps and one of three tokens through a cache,
    which the port updates in place."""
    jspec, tspec, jp, tp = _layer_params(dtype, seed=1)
    jrt, trt = runtimes(dtype)
    b, H, nh, dh = 2, tspec.d_model, tspec.n_heads, tspec.head_dim
    cdt = getattr(torch, dtype)
    jcache = {"wkv": jnp.zeros((b, nh, dh, dh), jnp.float32),
              "shift_tm": jnp.zeros((b, H), jnp.dtype(dtype)),
              "shift_cm": jnp.zeros((b, H), jnp.dtype(dtype))}
    tcache = {"wkv": torch.zeros(b, nh, dh, dh),
              "shift_tm": torch.zeros(b, H, dtype=cdt),
              "shift_cm": torch.zeros(b, H, dtype=cdt)}
    tensors = dict(tcache)
    for step, s in enumerate([1, 1, 1, 3, 1, 1]):
        jx, tx = _x(10 + step, b, s, dtype)
        want, jcache = JL.rwkv6_layer(jp, jx, jspec, jrt, None, cache=jcache)
        got, tcache = layers.rwkv6_layer(tp, tx, tspec, trt, cache=tcache)
        _close(got, want, tol)
    assert all(tcache[n] is tensors[n] for n in tensors)    # in place
    for n in tensors:
        _close(tcache[n], jcache[n], tol)


def test_token_shift():
    x = torch.arange(12.0).reshape(1, 4, 3)
    prev = torch.full((1, 3), -1.0)
    assert torch.equal(layers._token_shift(x, None)[0, 0], torch.zeros(3))
    assert torch.equal(layers._token_shift(x, prev)[0, 0], prev[0])
    assert torch.equal(layers._token_shift(x, prev)[:, 1:], x[:, :-1])


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def _tokens(seed, b, s, vocab=SMOKE.vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s))


def test_configs_agree_with_reference():
    theirs = jax_get("rwkv6-7b")
    for mine, ref_spec in ((ARCH.spec, theirs.spec), (ARCH.smoke, theirs.smoke)):
        assert mine.__dict__ == ref_spec.__dict__
        assert mine.params() == ref_spec.params()
    assert (ARCH.spec.n_layers, ARCH.spec.d_model, ARCH.spec.n_heads,
            ARCH.spec.head_dim, ARCH.spec.d_ff, ARCH.spec.vocab) == \
        (32, 4096, 64, 64, 14336, 65536)
    assert abs(ARCH.spec.params() - 7.53e9) < 0.01e9


def test_layer_pattern_and_params_tree():
    """Same keys, nesting, shapes and dtypes as the JAX package's tree."""
    assert lm.layer_pattern(SMOKE) == JLM.layer_pattern(JSMOKE) == (0, 1)
    assert lm._slot_kind(SMOKE, 0) == JLM._slot_kind(JSMOKE, 0)
    jparams, _ = shared_params(SMOKE)
    _, trt = runtimes()
    mine = init_params(SMOKE, trt, torch.Generator().manual_seed(0),
                       device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        pvalue(jparams))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), mine)
    assert got == want
    assert torch.all(mine["slots"][0]["rwkv"]["mu_r"] == 1)


def test_init_cache_matches_reference():
    jrt, trt = runtimes("bfloat16")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        JLM.init_cache(JSMOKE, jrt, 3, 16))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                       init_cache(SMOKE, trt, 3, 16, device="cpu"))
    assert got == want


@pytest.mark.parametrize("s", [24, 64, 40])
def test_forward_logits_fp32(s):
    jparams, tparams = shared_params(SMOKE)
    jrt, trt = runtimes()
    tok = _tokens(0, 2, s)
    want = JLM.forward(jparams, jnp.asarray(tok), JSMOKE, jrt)
    got = lm.forward(tparams, torch.from_numpy(tok), SMOKE, trt)
    assert got.shape == (2, s, SMOKE.vocab)
    _close(got, want)


def test_decode_steps_fp32():
    jparams, tparams = shared_params(SMOKE)
    jrt, trt = runtimes()
    jcache = JLM.init_cache(JSMOKE, jrt, 2, 8)
    tcache = init_cache(SMOKE, trt, 2, 8, device="cpu")
    wkv = tcache["slots"][0]["rwkv"]["wkv"]
    for step in range(6):
        tok = _tokens(10 + step, 2, 1)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(tok),
                                       JSMOKE, jrt)
        got, tcache = lm.decode_step(tparams, tcache, torch.from_numpy(tok),
                                     SMOKE, trt)
        _close(got, want)
    assert tcache["slots"][0]["rwkv"]["wkv"] is wkv      # updated in place
    for name in ("wkv", "shift_tm", "shift_cm"):
        _close(tcache["slots"][0]["rwkv"][name],
               jcache["slots"][0]["rwkv"][name])


def _jax_decode_all(jparams, tok):
    """Token-by-token logits of the JAX package, decode_step jitted."""
    step = jax.jit(lambda p, c, t: JLM.decode_step(p, c, t, JSMOKE,
                                                   runtimes()[0]))
    cache = JLM.init_cache(JSMOKE, runtimes()[0], tok.shape[0], 8)
    outs = []
    for i in range(tok.shape[1]):
        logits, cache = step(jparams, cache, jnp.asarray(tok[:, i:i + 1]))
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, axis=1)


def test_prefill_and_decode_differ_as_in_reference():
    """The reference's own prefill (chunks of 32, the -80/C floor acting on
    random weights) and its token-by-token decode (exact) differ by more
    than 0.1 on the smoke spec; the port reproduces each side to 1e-4."""
    jparams, tparams = shared_params(SMOKE)
    jrt, trt = runtimes()
    tok = _tokens(0, 2, 64)
    j_prefill = np.asarray(JLM.forward(jparams, jnp.asarray(tok), JSMOKE, jrt))
    j_decode = _jax_decode_all(jparams, tok)
    assert np.abs(j_prefill - j_decode).max() > 0.1
    t_prefill = lm.forward(tparams, torch.from_numpy(tok), SMOKE, trt)
    cache = init_cache(SMOKE, trt, 2, 8, device="cpu")
    t_decode = []
    for i in range(tok.shape[1]):
        logits, cache = lm.decode_step(tparams, cache,
                                       torch.from_numpy(tok[:, i:i + 1]),
                                       SMOKE, trt)
        t_decode.append(logits[:, 0])
    _close(t_prefill, j_prefill)
    _close(torch.stack(t_decode, dim=1), j_decode)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------

def test_engine_tokens_equal_reference():
    """Four requests over two slots: later requests inherit a slot's
    recurrent state, as in the JAX engine."""
    jparams, tparams = shared_params(SMOKE)
    jrt, trt = runtimes()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, SMOKE.vocab, size=rng.randint(3, 7))
               for _ in range(4)]

    def serve(engine, request_cls):
        for rid, pr in enumerate(prompts):
            engine.submit(request_cls(rid=rid, prompt=pr, max_new=4))
        return {r.rid: list(r.out) for r in engine.run(max_steps=64)}

    want = serve(JaxEngine(JSMOKE, jrt, jparams, batch_slots=2, kv_len=8),
                 JaxRequest)
    eng = Engine(SMOKE, trt, tparams, batch_slots=2, kv_len=8, device="cpu")
    got = serve(eng, Request)
    assert sorted(got) == [0, 1, 2, 3] and all(len(o) == 4 for o in got.values())
    assert got == want


def test_serve_launcher_on_cpu(capsys):
    done = serve_launcher.main(["--arch", "rwkv6-7b", "--smoke", "--device",
                                "cpu", "--requests", "3", "--max-new", "3",
                                "--slots", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "served 3/3" and len(done) == 3
    assert all(len(r.out) == 3 for r in done)


def test_entry_points_need_a_device_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(SMOKE, RuntimeCfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(SMOKE, RuntimeCfg(), 1, 4)
