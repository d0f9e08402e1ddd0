"""The port's MLA attention (deepseek-v2) and the flash-attention wrapper's
D_v != D_qk instance against the JAX package on the CPU.

``mla_attention`` is held against the reference's ``"naive"`` and
``"chunked"`` cores (the reference's Pallas kernel pads v to q's head dim and
returns q's width, so it does not compute MLA).  Weights are initialised by
the JAX package and carried across; activations come from numpy with a seed.
fp32 throughout, tolerance 1e-4 (the same arithmetic, another order of
sums)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import RuntimeCfg as JaxRuntimeCfg
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import lm
from torch_port_helpers import as_f32, port_spec, runtimes, shared_params

JSMOKE = jax_get("deepseek-v2-236b").smoke
SMOKE = port_spec(JSMOKE)
TOL = 1e-4
# the reference's cores: "naive", and "chunked" with chunks smaller than the
# keys so that its online softmax runs over several chunks
JAX_CORES = {"naive": JaxRuntimeCfg(param_dtype="float32",
                                    compute_dtype="float32",
                                    attention_impl="naive"),
             "chunked": JaxRuntimeCfg(param_dtype="float32",
                                      compute_dtype="float32",
                                      attention_impl="chunked", attn_chunk=4)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


def _layer():
    """The MLA attention params of the smoke spec's dense prefix layer."""
    jparams, tparams = shared_params(JSMOKE)
    return jparams["prefix"][0]["attn"], tparams["prefix"][0]["attn"]


def _x(b, s, seed):
    x = np.random.RandomState(seed).standard_normal(
        (b, s, SMOKE.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
@pytest.mark.parametrize("core", ["naive", "chunked"])
def test_mla_prefill(impl, core):
    """Prefill of 12 tokens: q/k of head dim 16 + 8 = 24, v of 16."""
    jp, tp = _layer()
    _, trt = runtimes(impl=impl)
    jx, tx = _x(2, 12, 0)
    want, jc = JL.mla_attention(jp, jx, JSMOKE, JAX_CORES[core], None)
    got, tc = TL.mla_attention(tp, tx, SMOKE, trt)
    assert jc is None and tc is None and got.shape == (2, 12, SMOKE.d_model)
    _close(got, want)


@pytest.mark.parametrize("impl", ["naive", "cuda"])
@pytest.mark.parametrize("core", ["naive", "chunked"])
def test_mla_decode_through_the_cache(impl, core):
    """Three new tokens at once into an empty 16-entry cache, then four
    single-token steps: outputs and the cached latent ckv and rope key kr
    step by step.  The cache is updated in place and pos advances."""
    jp, tp = _layer()
    _, trt = runtimes(impl=impl)
    m = SMOKE.mla
    jcache = JLM.init_cache(JSMOKE, JAX_CORES[core], 2, 16)["prefix"][0]["attn"]
    tcache = lm.init_cache(SMOKE, trt, 2, 16, device="cpu")["prefix"][0]["attn"]
    assert tuple(tcache["ckv"].shape) == (2, 16, m.kv_lora) \
        == jcache["ckv"].shape
    assert tuple(tcache["kr"].shape) == (2, 16, m.rope_dim) \
        == jcache["kr"].shape
    ckv = tcache["ckv"]
    for step, s in enumerate([3, 1, 1, 1, 1]):
        jx, tx = _x(2, s, 10 + step)
        want, jcache = JL.mla_attention(jp, jx, JSMOKE, JAX_CORES[core], None,
                                        cache=jcache)
        got, tcache = TL.mla_attention(tp, tx, SMOKE, trt, cache=tcache)
        _close(got, want)
        _close(tcache["ckv"], jcache["ckv"])
        _close(tcache["kr"], jcache["kr"])
        assert tcache["pos"] == int(jcache["pos"])
    assert tcache["ckv"] is ckv and tcache["pos"] == 7


def test_mla_cache_overflow_raises():
    _, tp = _layer()
    _, trt = runtimes(impl="cuda")
    cache = lm.init_cache(SMOKE, trt, 1, 4, device="cpu")["prefix"][0]["attn"]
    _, cache = TL.mla_attention(tp, torch.zeros(1, 3, SMOKE.d_model), SMOKE,
                                trt, cache=cache)
    with pytest.raises(ValueError, match="overflow"):
        TL.mla_attention(tp, torch.zeros(1, 2, SMOKE.d_model), SMOKE, trt,
                         cache=cache)


def _qkv(b, sq, sk, n, g, d, dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, sq, n, g, d)).astype(np.float32),
            rng.standard_normal((b, sk, n, d)).astype(np.float32),
            rng.standard_normal((b, sk, n, dv)).astype(np.float32))


@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128), (32, 8), (16, 16)])
@pytest.mark.parametrize("case", [
    dict(sq=9, sk=9, causal=True, q_offset=0),
    dict(sq=1, sk=20, causal=True, q_offset=13),
    dict(sq=5, sk=12, causal=False, q_offset=0),
], ids=["prefill", "decode", "full"])
def test_flash_plain_dv_differs(d, dv, case):
    """flash_attention_plain (what the kernel computes) with v's head dim
    other than q/k's, against the JAX package's attn_naive: the output has
    v's width, the scale is 1/sqrt(D) of q."""
    q, k, v = _qkv(2, case["sq"], case["sk"], 2, 3, d, dv, d + dv)
    kw = dict(causal=case["causal"], window=None, softcap=None,
              q_offset=case["q_offset"])
    want = JL.attn_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    assert got.shape == (2, case["sq"], 2, 3, dv) == want.shape
    _close(got, want, 1e-5)
    # the port's naive core and the wrapper agree
    _close(TL.attn_naive(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), **kw), got, 1e-5)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=kw["causal"],
                              q_offset=kw["q_offset"])
    assert torch.equal(out, got)


def test_flash_bhsd_dv_differs():
    """The [B,H,S,D] entry returns [B,H,Sq,Dv]."""
    q, k, v = _qkv(2, 7, 7, 2, 2, 24, 16, 5)
    qb = torch.from_numpy(q).permute(0, 2, 3, 1, 4).reshape(2, 4, 7, 24)
    kb = torch.from_numpy(k).transpose(1, 2)
    vb = torch.from_numpy(v).transpose(1, 2)
    out = fa.flash_attention_bhsd(qb, kb, vb, causal=True)
    assert out.shape == (2, 4, 7, 16)
    want = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True)
    _close(out, want.permute(0, 2, 3, 1, 4).reshape(2, 4, 7, 16), 1e-6)


@pytest.mark.parametrize("bad", ["v-keys", "v-heads", "v-batch", "k-width"])
def test_wrapper_refuses_mismatched_v(bad):
    q = torch.zeros(1, 4, 2, 2, 24)
    k = torch.zeros(1, 4, 2, 24)
    v = torch.zeros(1, 4, 2, 16)
    if bad == "v-keys":
        v = torch.zeros(1, 5, 2, 16)
    elif bad == "v-heads":
        v = torch.zeros(1, 4, 3, 16)
    elif bad == "v-batch":
        v = torch.zeros(2, 4, 2, 16)
    else:
        k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="belong together"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("d,dv,match", [
    (200, 128, "q/k head dims"), (196, 128, "q/k head dims"),
    (192, 136, "v head dims"), (64, 96, "v head dims"), (24, 18, "v head dims"),
])
def test_kernel_refuses_what_the_card_does_not_take(d, dv, match):
    """On the card D <= 192 and Dv <= min(D, 128), both multiples of 4; the
    launch refuses anything else before it reaches the device."""
    q = torch.zeros(1, 2, 1, 1, d, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 1, d, dtype=torch.bfloat16)
    v = torch.zeros(1, 2, 1, dv, dtype=torch.bfloat16)
    out = torch.empty(1, 2, 1, 1, dv, dtype=torch.bfloat16)
    before = fa.launches
    with pytest.raises(ValueError, match=match):
        fa._launch(q, k, v, out, True, None, None, 0)
    assert fa.launches == before


def test_variant_and_split_of_the_mla_shapes():
    """deepseek-v2's prefill goes to the tensor-core kernel and its decode
    step to the decode kernel; the decode target is two blocks per SM for
    the D = 192 bf16 instance, three otherwise; the smoke spec's fp32 prefill
    goes to the fma kernel."""
    bf = torch.bfloat16
    q = torch.zeros(2, 64, 128, 1, 192, dtype=bf)
    k = torch.zeros(2, 64, 128, 192, dtype=bf)
    v = torch.zeros(2, 64, 128, 128, dtype=bf)
    assert fa._variant(q, k, v) == "tc"
    assert fa._variant(q[:, :1], k, v) == "decode"
    assert fa.decode_target_blocks(bf, 192) == 2 * 132
    assert fa.decode_target_blocks(bf, 128) == fa.DECODE_TARGET_BLOCKS
    assert fa.decode_target_blocks(torch.float32, 192) == \
        fa.DECODE_TARGET_BLOCKS
    # 8 slots x 128 heads already fill more than a wave: one split
    assert fa.decode_splits(8, 128, 2048, fa.decode_target_blocks(bf, 192)) == 1
    assert fa.decode_splits(1, 4, 4096, 2 * 132) == 32
    q32 = torch.zeros(2, 9, 8, 1, 24)
    k32, v32 = torch.zeros(2, 9, 8, 24), torch.zeros(2, 9, 8, 16)
    assert fa._variant(q32, k32, v32) == "fma"
    # a v whose head dim is not whole 16-byte pieces sends bf16 to fma
    assert fa._variant(q, k, torch.zeros(2, 64, 128, 124, dtype=bf)) == "fma"
