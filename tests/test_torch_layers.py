"""Layer functions of the port against the JAX package's, in fp32 on the
CPU, same numpy inputs and weights through both.  Tolerance 1e-5: both sides
do the same fp32 arithmetic, only the order of sums differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ModelSpec as JaxModelSpec
from repro.models import layers as JL
from repro.models.common import Param
from repro_torch import ModelSpec
from repro_torch.models import layers as TL
from torch_port_helpers import as_f32, runtimes, to_jax, to_torch

TOL = 1e-5
SPEC_KW = dict(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
               d_ff=96, vocab=64, d_head=16, qk_norm=True)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _p(a):
    """A JAX-side parameter (the logical axes are not read without rules)."""
    return Param(to_jax(a), ("x",) * a.ndim)


@pytest.mark.parametrize("shape", [(2, 5, 32), (2, 5, 2, 3, 16), (2, 5, 2, 16)])
def test_rms_norm(shape):
    rng = np.random.RandomState(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    _close(TL.rms_norm(to_torch(w), to_torch(x)), JL.rms_norm(_p(w), to_jax(x)))


def test_rms_norm_bf16_keeps_dtype():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = np.ones(32, np.float32)
    got = TL.rms_norm(to_torch(w, "bfloat16"), to_torch(x, "bfloat16"))
    want = JL.rms_norm(Param(to_jax(w, "bfloat16"), ("x",)),
                       to_jax(x, "bfloat16"))
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)            # one bf16 ulp at |x| < 4


@pytest.mark.parametrize("shape", [(2, 7, 16), (2, 7, 2, 16), (2, 7, 2, 3, 16),
                                   (1, 4, 2, 10), (1, 4, 2, 7)])
def test_rope(shape):
    rng = np.random.RandomState(2)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.randint(0, 500, size=shape[:2]).astype(np.int32)
    got = TL.rope(to_torch(x), torch.from_numpy(pos))
    want = JL.rope(to_jax(x), jnp.asarray(pos))
    _close(got, want)


@pytest.mark.parametrize("gated", [True, False], ids=["silu-gated", "gelu-tanh"])
def test_ffn(gated):
    rng = np.random.RandomState(3)
    H, Fd = 32, 48
    names = ["ln", "w_up", "w_down"] + (["w_gate"] if gated else [])
    shapes = {"ln": (H,), "w_up": (H, Fd), "w_down": (Fd, H), "w_gate": (H, Fd)}
    w = {n: rng.standard_normal(shapes[n]).astype(np.float32) * 0.3
         for n in names}
    x = rng.standard_normal((2, 5, H)).astype(np.float32)
    jrt, trt = runtimes()
    want = JL.ffn({n: _p(a) for n, a in w.items()}, to_jax(x), None, jrt, None)
    got = TL.ffn({n: to_torch(a) for n, a in w.items()}, to_torch(x), None, trt)
    _close(got, want)


def _gqa_weights(rng, spec):
    H, D = spec.d_model, spec.head_dim
    n, g = spec.n_kv_heads, spec.n_heads // spec.n_kv_heads
    shapes = {"ln": (H,), "w_q": (H, n, g, D), "w_k": (H, n, D),
              "w_v": (H, n, D), "w_o": (n, g, D, H)}
    if spec.qk_norm:
        shapes.update(qn=(D,), kn=(D,))
    return {k: (rng.standard_normal(s) * (0.2 if len(s) > 1 else 1.0))
            .astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("impl", ["naive", "cuda"])
@pytest.mark.parametrize("extra", [{}, {"window": 4}, {"attn_softcap": 20.0},
                                   {"qk_norm": False},
                                   {"window": 3, "attn_softcap": 10.0},
                                   {"n_kv_heads": 4}],
                         ids=["plain", "window", "softcap", "no-qk-norm",
                              "window-softcap", "one-query-head-per-kv"])
def test_gqa_prefill(impl, extra):
    """Every attention core of the port against the JAX 'naive' core;
    'cuda' runs the kernel's plain version here."""
    kw = {**SPEC_KW, **extra}
    jspec, tspec = JaxModelSpec(**kw), ModelSpec(**kw)
    rng = np.random.RandomState(4)
    w = _gqa_weights(rng, tspec)
    x = rng.standard_normal((2, 12, tspec.d_model)).astype(np.float32)
    jrt, trt = runtimes(impl=impl, jax_impl="naive")
    want, _ = JL.gqa_attention({k: _p(a) for k, a in w.items()}, to_jax(x),
                               jspec, jrt, None, window=kw.get("window"))
    got, cache = TL.gqa_attention({k: to_torch(a) for k, a in w.items()},
                                  to_torch(x), tspec, trt,
                                  window=kw.get("window"))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
@pytest.mark.parametrize("window,klen", [(None, 8), (16, 8), (4, 4)],
                         ids=["full-cache", "window-in-full-cache", "ring"])
def test_gqa_decode(impl, window, klen):
    """Six decode steps through the cache; window 4 over a 4-entry cache is
    the ring (shift + append) branch.  The port updates its cache in place."""
    kw = {**SPEC_KW, "window": window}
    jspec, tspec = JaxModelSpec(**kw), ModelSpec(**kw)
    rng = np.random.RandomState(5)
    w = _gqa_weights(rng, tspec)
    B, n, D = 2, tspec.n_kv_heads, tspec.head_dim
    jrt, trt = runtimes(impl=impl, jax_impl="naive")
    jcache = {"k": jnp.zeros((B, klen, n, D)), "v": jnp.zeros((B, klen, n, D)),
              "pos": jnp.zeros((), jnp.int32)}
    tcache = {"k": torch.zeros(B, klen, n, D), "v": torch.zeros(B, klen, n, D),
              "pos": 0}
    tk = tcache["k"]
    jp = {k: _p(a) for k, a in w.items()}
    tp = {k: to_torch(a) for k, a in w.items()}
    for step in range(6):
        x = rng.standard_normal((B, 1, tspec.d_model)).astype(np.float32)
        want, jcache = JL.gqa_attention(jp, to_jax(x), jspec, jrt, None,
                                        window=window, cache=jcache)
        got, tcache = TL.gqa_attention(tp, to_torch(x), tspec, trt,
                                       window=window, cache=tcache)
        _close(got, want)
        assert tcache["pos"] == int(jcache["pos"]) == step + 1
    assert tcache["k"] is tk                       # same storage, updated
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_cache_overflow_raises():
    tspec = ModelSpec(**SPEC_KW)
    rng = np.random.RandomState(6)
    tp = {k: to_torch(a) for k, a in _gqa_weights(rng, tspec).items()}
    _, trt = runtimes()
    cache = {"k": torch.zeros(1, 2, 2, 16), "v": torch.zeros(1, 2, 2, 16),
             "pos": 2}
    with pytest.raises(ValueError, match="overflow"):
        TL.gqa_attention(tp, torch.zeros(1, 1, 64), tspec, trt, cache=cache)


def test_attn_core_unknown_impl_raises():
    _, trt = runtimes(impl="pallas")
    q = torch.zeros(1, 2, 1, 1, 16)
    with pytest.raises(ValueError, match="attention_impl"):
        TL.attn_core(q, q[:, :, :, 0], q[:, :, :, 0], trt, causal=True)


def test_default_runtime_goes_through_the_kernel_wrapper(monkeypatch):
    """A default RuntimeCfg reaches the kernel's wrapper, so on a CUDA tensor
    no caller gets the materialised-score core without asking for it."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import RuntimeCfg
    calls = []
    real = kops.flash_attention

    def counting(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(kops, "flash_attention", counting)
    rt = RuntimeCfg()
    assert rt.attention_impl == "cuda"
    rng = np.random.RandomState(7)
    q = to_torch(rng.standard_normal((1, 3, 2, 2, 16)).astype(np.float32))
    k = to_torch(rng.standard_normal((1, 5, 2, 16)).astype(np.float32))
    got = TL.attn_core(q, k, k, rt, causal=True, q_offset=2)
    assert len(calls) == 1 and calls[0]["q_offset"] == 2
    want = TL.attn_naive(q, k, k, causal=True, window=None, softcap=None,
                         q_offset=2)
    _close(got, want)


@pytest.mark.parametrize("window,softcap,q_offset,sq", [
    (None, None, 0, 12), (4, 20.0, 0, 12), (None, None, 11, 1)],
    ids=["causal", "window-softcap", "decode"])
@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_attn_core_cuda_at_any_runtime_dtype(dtype, window, softcap, q_offset,
                                             sq):
    """A float16 or float64 runtime with ``attention_impl="cuda"``: q, k, v
    reach the kernel's wrapper in a dtype it reads (fp32), and the output
    comes back in q's dtype, as the Pallas kernel computes in fp32 and
    returns q's dtype.  Against the JAX ``attn_core`` on its Pallas path
    (interpret mode) with float64 enabled: 2e-5 as in fp32, plus one ulp
    of the output for float16."""
    from repro_torch.kernels import ops as kops
    seen = []
    real = kops.flash_attention

    def recording(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)

    rng = np.random.RandomState(8)
    qa = rng.standard_normal((2, sq, 2, 2, 16))
    ka, va = (rng.standard_normal((2, 12, 2, 16)) for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    jrt, trt = runtimes(dtype, impl="cuda", jax_impl="pallas")
    with jax.enable_x64(True):
        want = JL.attn_core(*(to_jax(a, dtype) for a in (qa, ka, va)), jrt,
                            **kw)
        want = np.asarray(want, np.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kops, "flash_attention", recording)
        got = TL.attn_core(*(to_torch(a, dtype) for a in (qa, ka, va)), trt,
                           **kw)
    assert seen and all(d in kops.FLASH_INPUT_DTYPES for d in seen[0])
    assert got.dtype == getattr(torch, dtype) and got.shape == qa.shape
    tol = 2e-5 if dtype == "float64" else 2e-5 + 2.0 ** -10
    np.testing.assert_allclose(got.double().numpy(), want, atol=tol,
                               rtol=tol)
