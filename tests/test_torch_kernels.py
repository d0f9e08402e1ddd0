"""The port's attention oracle, plain version and wrappers against the JAX
package's oracle and its Pallas kernel (interpret mode), on the CPU.

On the CPU the port's wrappers compute ``flash_attention_plain``; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py``.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 in fp32, 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash_bhsd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from torch_port_helpers import as_f32, to_jax, to_torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


SHAPES = [
    (1, 1, 128, 128, 64),
    (2, 3, 256, 256, 64),
    (1, 2, 64, 384, 128),       # kv longer than q
    (2, 2, 96, 160, 80),        # ragged: D=80, lengths not tile multiples
]


@pytest.mark.parametrize("b,h,sq,sk,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_and_plain_vs_jax_ref(b, h, sq, sk, d, dtype, causal):
    q, k, v = _qkv(0, b, h, sq, sk, d)
    want = jref.ref_attention(*(to_jax(t, dtype) for t in (q, k, v)),
                              causal=causal)
    tq, tk, tv = (to_torch(t, dtype) for t in (q, k, v))
    _close(ref.ref_attention(tq, tk, tv, causal=causal), want, TOL[dtype])
    got = fa.flash_attention_bhsd(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_plain_vs_pallas_interpret_ragged(dtype, causal):
    """D=80 and ragged lengths: the Pallas kernel pads, the port masks."""
    q, k, v = _qkv(1, 2, 2, 96, 160, 80)
    want = jax_flash_bhsd(*(to_jax(t, dtype) for t in (q, k, v)),
                          causal=causal, interpret=True, block_q=64,
                          block_k=128)
    got = fa.flash_attention_bhsd(*(to_torch(t, dtype) for t in (q, k, v)),
                                  causal=causal)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("window,softcap", [(32, None), (None, 20.0),
                                            (64, 30.0)])
def test_window_softcap(window, softcap):
    q, k, v = _qkv(2, 1, 2, 256, 256, 64)
    jq, jk, jv = (to_jax(t) for t in (q, k, v))
    tq, tk, tv = (to_torch(t) for t in (q, k, v))
    kw = dict(causal=True, window=window, softcap=softcap)
    want_ref = jref.ref_attention(jq, jk, jv, **kw)
    want_pallas = jax_flash_bhsd(jq, jk, jv, interpret=True, **kw)
    _close(ref.ref_attention(tq, tk, tv, **kw), want_ref, 2e-5)
    got = fa.flash_attention_bhsd(tq, tk, tv, **kw)
    _close(got, want_ref, 2e-5)
    _close(got, want_pallas, 3e-5)     # the reference's own 3e-5 for this case


def test_q_offset_decode():
    """Single-token decode against a longer KV context, q_offset = Sk-1."""
    b, h, sk, d = 2, 2, 256, 64
    q, k, v = _qkv(3, b, h, 1, sk, d)
    jq, jk, jv = (to_jax(t) for t in (q, k, v))
    kw = dict(causal=True, q_offset=sk - 1)
    want = jref.ref_attention(jq, jk, jv, **kw)
    want_pallas = jax_flash_bhsd(jq, jk, jv, interpret=True, **kw)
    tq, tk, tv = (to_torch(t) for t in (q, k, v))
    _close(ref.ref_attention(tq, tk, tv, **kw), want, 2e-5)
    _close(fa.flash_attention_bhsd(tq, tk, tv, **kw), want, 2e-5)
    _close(fa.flash_attention_bhsd(tq, tk, tv, **kw), want_pallas, 2e-5)


@pytest.mark.parametrize("q_offset", [0, 5, 40])
def test_q_offset_partial_cache(q_offset):
    """A decode step in the middle of a cache: keys past q_offset are
    invisible whatever they hold."""
    q, k, v = _qkv(4, 2, 4, 1, 64, 16)
    tq, tk, tv = (to_torch(t) for t in (q, k, v))
    got = fa.flash_attention_bhsd(tq, tk, tv, causal=True, q_offset=q_offset)
    n = q_offset + 1
    want = jref.ref_attention(to_jax(q), to_jax(k[:, :, :n]),
                              to_jax(v[:, :, :n]), causal=False)
    _close(got, want, 2e-5)


def test_model_layout_wrapper_vs_jax_ops():
    """ops.flash_attention: q [B,S,N,G,D], k/v [B,Sk,N,D]; kv heads are
    shared by G query heads, not repeated."""
    B, S, N, G, D = 2, 64, 2, 2, 32
    rng = np.random.RandomState(5)
    q = rng.standard_normal((B, S, N, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, N, D)).astype(np.float32)
    v = rng.standard_normal((B, S, N, D)).astype(np.float32)
    want = jops.flash_attention(to_jax(q), to_jax(k), to_jax(v), causal=True,
                                interpret=True)
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=True)
    assert got.shape == (B, S, N, G, D) and got.is_contiguous()
    _close(got, want, 2e-5)
    plain = fa.flash_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                     causal=True)
    assert torch.equal(got, plain)      # on the CPU the wrapper IS the plain version


def test_bhsd_grouped_kv_heads():
    """flash_attention_bhsd with Hk < H reads kv head h // G."""
    q, _, _ = _qkv(6, 2, 6, 32, 32, 16)
    _, k, v = _qkv(7, 2, 2, 32, 32, 16)
    got = fa.flash_attention_bhsd(to_torch(q), to_torch(k), to_torch(v))
    want = jref.ref_attention(to_jax(q), jnp.repeat(to_jax(k), 3, axis=1),
                              jnp.repeat(to_jax(v), 3, axis=1))
    _close(got, want, 2e-5)


def test_strided_views_match_contiguous():
    """The wrapper takes views (a cache slice, a transposed tensor) as they
    are and gives what it gives for their contiguous copies."""
    rng = np.random.RandomState(8)
    q = to_torch(rng.standard_normal((2, 4, 2, 3, 16)).astype(np.float32))
    cache_k = to_torch(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    cache_v = to_torch(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    kview, vview = cache_k[:, 7:31], cache_v[:, 7:31]
    assert not kview.is_contiguous()
    got = ops.flash_attention(q, kview, vview, causal=False)
    want = ops.flash_attention(q, kview.contiguous(), vview.contiguous(),
                               causal=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sq,sk,q_offset,causal,window,dtype", [
    (4, 8, 20, False, 4, "float32"),    # no row sees a key
    (6, 8, 7, False, 4, "float32"),     # rows 0-3 see keys, rows 4-5 none
    (1, 8, 20, False, 4, "float32"),    # one row (the decode shape)
    (1, 8, 20, True, 4, "float32"),     # causal: the window still hides all
    (4, 8, 20, False, 4, "bfloat16"),
])
def test_row_without_visible_key_matches_ref(sq, sk, q_offset, causal, window,
                                             dtype):
    """A row with no visible key returns the mean of v over all Sk keys, as
    the JAX package's oracle does (every score -1e30, softmax uniform)."""
    q, k, v = _qkv(9, 1, 2, sq, sk, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jref.ref_attention(*(to_jax(t, dtype) for t in (q, k, v)), **kw)
    got = fa.flash_attention_bhsd(*(to_torch(t, dtype) for t in (q, k, v)),
                                  **kw)
    _close(got, want, TOL[dtype])
    _close(ref.ref_attention(*(to_torch(t, dtype) for t in (q, k, v)), **kw),
           want, TOL[dtype])


@pytest.mark.parametrize("bad", ["dtype", "heads", "rank", "window", "kv"])
def test_wrapper_refuses(bad):
    q = torch.zeros(1, 4, 2, 2, 16)
    k = torch.zeros(1, 4, 2, 16)
    v = torch.zeros(1, 4, 2, 16)
    kw = {}
    if bad == "dtype":
        k = k.bfloat16()
    elif bad == "heads":
        k, v = torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 3, 16)
    elif bad == "rank":
        q = q[:, :, :, 0]
    elif bad == "window":
        kw["window"] = 0
    elif bad == "kv":
        v = torch.zeros(1, 5, 2, 16)
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, v, **kw)


def test_launch_count_untouched_on_cpu():
    """The count moves only where the CUDA kernel is launched."""
    before = fa.launches
    ops.flash_attention(torch.zeros(1, 2, 1, 1, 16), torch.zeros(1, 2, 1, 16),
                        torch.zeros(1, 2, 1, 16))
    assert fa.launches == before


# ---------------------------------------------------------------------------
# which kernel a CUDA call goes to, the decode split, the layout checks: pure
# Python, so they are held here on CPU tensors (strides and addresses only)
# ---------------------------------------------------------------------------

def _padded(shape, dtype, pad):
    """A view of ``shape`` whose rows are ``pad`` elements longer than D."""
    base = torch.zeros(*shape[:-1], shape[-1] + pad, dtype=dtype)
    return base[..., :shape[-1]]


@pytest.mark.parametrize("case,want", [
    ("bf16-d128", "tc"),                # the qwen3 prefill shape, aligned
    ("bf16-d80", "tc"),                 # ragged head dim, still 16-byte rows
    ("fp32", "fma"),                    # fp32 keeps IEEE fp32 arithmetic
    ("bf16-d20", "fma"),                # D not a multiple of 8
    ("bf16-misaligned", "fma"),         # row stride 132 elements: not 16 B
    ("bf16-offset", "fma"),             # base address 8 bytes off
    ("bf16-decode", "decode"),          # Sq = 1
    ("fp32-decode", "decode"),
    ("bf16-decode-d20", "fma"),         # Sq = 1 but 16-byte loads do not fit
])
def test_variant_rule(case, want):
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    d = {"bf16-d80": 80, "bf16-d20": 20, "bf16-decode-d20": 20}.get(case, 128)
    sq = 1 if "decode" in case else 64
    q = torch.zeros(2, sq, 2, 5, d, dtype=dtype)
    k = torch.zeros(2, 64, 2, d, dtype=dtype)
    v = torch.zeros(2, 64, 2, d, dtype=dtype)
    if case == "bf16-misaligned":
        k = _padded((2, 64, 2, d), dtype, 4)
    if case == "bf16-offset":
        v = torch.zeros(2 * 64 * 2 * d + 4, dtype=dtype)[4:].view(2, 64, 2, d)
    assert fa._variant(q, k, v) == want


def test_variant_of_the_served_layouts():
    """The model's prefill tensors and a decode step's cache view (a slice
    of a [B, kv_len, N, D] cache) take the tensor-core and decode kernels."""
    q = torch.zeros(2, 2048, 8, 5, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 2048, 8, 128, dtype=torch.bfloat16)
    assert fa._variant(q, k, k) == "tc"
    cache = torch.zeros(8, 2048, 8, 128, dtype=torch.bfloat16)
    q1 = torch.zeros(8, 1, 8, 5, 128, dtype=torch.bfloat16)
    assert fa._variant(q1, cache, cache) == "decode"
    assert fa._variant(q1, cache[:, :137], cache[:, :137]) == "decode"
    # the [B,H,S,D] entry's views keep the rule
    qb = torch.zeros(2, 40, 64, 128, dtype=torch.bfloat16)
    qv = qb.unflatten(1, (8, 5)).permute(0, 3, 1, 2, 4)
    kb = torch.zeros(2, 8, 64, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert fa._variant(qv, kb, kb) == "tc"


@pytest.mark.parametrize("b,n,visible", [
    (8, 8, 1), (8, 8, 101), (8, 8, 137), (8, 8, 256),   # the engine's ranges
    (8, 8, 0), (1, 1, 256),
])
def test_decode_splits_short_range_is_one_block(b, n, visible):
    assert fa.decode_splits(b, n, visible) == 1


def test_decode_splits_fill_the_card_at_the_long_cache():
    """B = 8, N = 8 kv heads (one chunk of G = 5), 2048 keys: at least two
    blocks per SM of the H100's 132, all in one resident wave."""
    s = fa.decode_splits(8, 8, 2048)
    assert 264 <= 8 * 8 * s <= fa.DECODE_TARGET_BLOCKS and s <= 2048 // 128


@pytest.mark.parametrize("b,n", [(1, 1), (1, 2), (2, 4), (4, 4), (8, 8),
                                 (16, 8), (64, 8), (300, 1)])
@pytest.mark.parametrize("visible", [257, 300, 511, 1000, 2048, 4096, 32768])
def test_decode_splits_bounds(b, n, visible):
    """At least one split and never more than whole 128-key pieces; no more
    blocks than one resident wave unless one split per unit already is; and
    no further split would fit in that wave."""
    s = fa.decode_splits(b, n, visible)
    pieces = visible // fa.DECODE_MIN_SPLIT
    assert 1 <= s <= max(1, pieces)
    assert s == 1 or b * n * s <= fa.DECODE_TARGET_BLOCKS
    assert s == pieces or b * n * (s + 1) > fa.DECODE_TARGET_BLOCKS
    split_len = -(-visible // s)
    assert (s - 1) * split_len < visible        # no split is empty


@pytest.mark.parametrize("sk,causal,window,q_offset,want", [
    (2048, True, None, 2047, (0, 2048)),
    (2048, True, None, 100, (0, 101)),
    (500, True, 128, 400, (273, 401)),
    (77, False, None, 0, (0, 77)),
    (128, False, 16, 300, (285, 128)),          # empty: no visible key
])
def test_decode_range(sk, causal, window, q_offset, want):
    assert fa._decode_range(sk, causal, window, q_offset) == want


@pytest.mark.parametrize("bad", ["tc-misaligned", "tc-d20", "decode-offset",
                                 "fma-stride", "not-contiguous"])
def test_cuda_layout_checks_refuse(bad):
    """What the chosen kernel cannot take is refused before a launch: the
    tc and decode kernels read q, k, v 16 bytes at a time, the fma kernel 4
    elements at a time along a contiguous head dim."""
    bf = torch.bfloat16
    variant, t = {
        "tc-misaligned": ("tc", _padded((2, 64, 2, 128), bf, 4)),
        "tc-d20": ("tc", torch.zeros(2, 64, 2, 20, dtype=bf)),
        "decode-offset": ("decode", torch.zeros(2 * 64 * 128 + 4, dtype=bf)
                          [4:].view(2, 64, 128)),
        "fma-stride": ("fma", _padded((2, 64, 2, 16), torch.float32, 2)),
        "not-contiguous": ("fma", torch.zeros(2, 16, 64).transpose(1, 2)),
    }[bad]
    with pytest.raises(ValueError):
        fa._check_cuda("k", t, variant)


def test_cuda_layout_checks_accept_the_served_layouts():
    q = torch.zeros(2, 64, 8, 5, 128, dtype=torch.bfloat16)
    cache = torch.zeros(8, 2048, 8, 128, dtype=torch.bfloat16)[:, :100]
    for variant in ("tc", "decode", "fma"):
        fa._check_cuda("q", q, variant)
        fa._check_cuda("k", cache, variant)
    # the output is written 4 bytes at a time: only the fma rule applies
    fa._check_cuda("out", _padded((2, 64, 2, 128), torch.bfloat16, 4), "tc")


# ---------------------------------------------------------------------------
# cost_reduce: out[b, e] = sum_t x[b, t] * w[e, t]
# ---------------------------------------------------------------------------

from repro.kernels.cost_reduce import cost_reduce_bet as jax_cost_reduce_bet  # noqa: E402
from repro_torch.kernels import cost_reduce as cr  # noqa: E402


@pytest.mark.parametrize("b,e,t", [
    (1, 1, 1),
    (4, 7, 33),             # all dims below one TPU tile (padding path)
    (128, 128, 128),        # exactly one TPU tile
    (130, 257, 140),        # multi-tile with ragged remainders
])
def test_cost_reduce_plain_vs_pallas_interpret(b, e, t):
    """The reference's shapes and its 1e-4 (tests/test_kernels.py)."""
    rng = np.random.RandomState(7)
    x = rng.standard_normal((b, t)).astype(np.float32)
    w = rng.standard_normal((e, t)).astype(np.float32)
    want = jax_cost_reduce_bet(to_jax(x), to_jax(w), interpret=True)
    got = ops.cost_reduce(to_torch(x), to_torch(w))
    assert got.shape == (b, e) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_cost_reduce_plain_f64_vs_numpy():
    """The float64 plain version is double-precision close to numpy's
    product (1e-14 fails by ~7 digits for a sum in float32)."""
    rng = np.random.default_rng(11)
    x, w = rng.standard_normal((5, 37)), rng.standard_normal((9, 37))
    got = cr.cost_reduce_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), x @ w.T, rtol=1e-14, atol=1e-14)
    assert torch.equal(ops.cost_reduce(torch.from_numpy(x),
                                       torch.from_numpy(w)), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cost_reduce_counts_semantics(dtype):
    """Integer selection rows act as exact gather-sums: 0/1/k weights stay
    exact (the reference's test_cost_reduce_counts_semantics)."""
    x = torch.arange(1, 13, dtype=dtype).reshape(2, 6)
    w = torch.tensor([[1, 0, 1, 0, 0, 0],
                      [0, 2, 0, 0, 0, 3]], dtype=dtype)
    want = torch.tensor([[1 + 3, 2 * 2 + 3 * 6],
                         [7 + 9, 2 * 8 + 3 * 12]], dtype=dtype)
    assert torch.equal(ops.cost_reduce(x, w), want)
    jx = jnp.arange(1, 13, dtype=jnp.float32).reshape(2, 6)
    jw = jnp.asarray(w.float().numpy())
    assert np.array_equal(np.asarray(jax_cost_reduce_bet(jx, jw,
                                                         interpret=True)),
                          want.float().numpy())


def test_cost_reduce_counts_no_launch_on_cpu():
    before = cr.launches
    ops.cost_reduce(torch.ones(3, 4, dtype=torch.float64),
                    torch.ones(2, 4, dtype=torch.float64))
    assert cr.launches == before


@pytest.mark.parametrize("bad", ["rank", "terms", "dtype", "mixed-dtype",
                                 "strided", "int"])
def test_cost_reduce_refuses(bad):
    """Wrong ranks, a T that differs and integer inputs are refused.  bf16
    x and w, a w of another dtype than x and strided x, refused before, now
    give the reference's result: the JAX wrapper casts w to x's dtype, and
    its Pallas kernel takes any float dtype and layout."""
    rng = np.random.RandomState(3)
    xa = rng.standard_normal((3, 16))
    wa = rng.standard_normal((2, 8))
    x, w = torch.from_numpy(xa[:, :8].copy()), torch.from_numpy(wa)
    jx, jw = xa[:, :8], wa
    if bad in ("rank", "terms", "int"):
        if bad == "rank":
            x = x[0]
        elif bad == "terms":
            w = torch.zeros(2, 9, dtype=torch.float64)
        else:
            x, w = x.long(), w.long()
        with pytest.raises((TypeError, ValueError)):
            ops.cost_reduce(x, w)
        return
    if bad == "dtype":
        x, w = x.bfloat16(), w.bfloat16()
        jx, jw = to_jax(jx, "bfloat16"), to_jax(jw, "bfloat16")
        tol = 2e-2
    elif bad == "mixed-dtype":
        w = w.float()
        jw = jw.astype(np.float32)
        tol = 1e-12
    else:
        x = torch.from_numpy(xa)[:, ::2]
        jx = xa[:, ::2]
        tol = 1e-12
    with jax.enable_x64(True):
        want = np.asarray(jops.cost_reduce(jnp.asarray(jx), jnp.asarray(jw)),
                          np.float64)
    got = ops.cost_reduce(x, w)
    assert got.dtype == x.dtype and got.shape == (3, 2)
    np.testing.assert_allclose(got.double().numpy(), want, atol=tol, rtol=tol)


def _busy_rows(rng, e, t):
    """Busy-group rows as the batched backend stacks them: every slot in
    exactly one of the E rows (compute rows of the groups, then comm)."""
    w = np.zeros((e, t))
    w[rng.randint(0, e, size=t), np.arange(t)] = 1.0
    return w


@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("bfloat16", "float32"), ("float16", "float16"), ("float16", "float64"),
    ("float32", "float64"), ("float64", "float32")])
def test_cost_reduce_dtypes_vs_reference(x_dtype, w_dtype):
    """Any float dtypes: w cast to x's dtype as the reference does, half
    types computed in fp32 and returned in x's dtype; against the JAX
    wrapper with float64 enabled (1e-12 where x is float64, the reference's
    1e-4 in float32, one half ulp of the output's scale in the half types)."""
    rng = np.random.RandomState(4)
    xa = rng.uniform(0.0, 1.0, (5, 300))
    wa = _busy_rows(rng, 6, 300)
    with jax.enable_x64(True):
        want = np.asarray(jops.cost_reduce(to_jax(xa, x_dtype),
                                           to_jax(wa, w_dtype)), np.float64)
    got = ops.cost_reduce(to_torch(xa, x_dtype), to_torch(wa, w_dtype))
    assert got.dtype == getattr(torch, x_dtype) and got.shape == (5, 6)
    tol = {"float64": 1e-12, "float32": 1e-4}.get(x_dtype, 2e-2)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("layout", ["x-row-stride", "x-columns-strided",
                                    "w-transposed-view", "x-offset-view"])
def test_cost_reduce_layouts_vs_reference(layout):
    """Rows read by a stride, views whose rows are not contiguous (the
    wrapper copies them) and views at an offset: the reference's result,
    as for contiguous inputs."""
    rng = np.random.RandomState(5)
    big = rng.standard_normal((7, 2 * 301))
    wa = rng.standard_normal((9, 301))
    w = torch.from_numpy(wa)
    if layout == "x-row-stride":
        x, xa = torch.from_numpy(big)[:, :301], big[:, :301]
    elif layout == "x-columns-strided":
        x, xa = torch.from_numpy(big)[:, ::2][:, :301], big[:, ::2][:, :301]
    elif layout == "w-transposed-view":
        x, xa = torch.from_numpy(big[:, :301].copy()), big[:, :301]
        w = torch.from_numpy(wa.T.copy()).T
    else:
        x, xa = torch.from_numpy(big)[1:, 3:304], big[1:, 3:304]
    with jax.enable_x64(True):
        want = np.asarray(jops.cost_reduce(jnp.asarray(xa), jnp.asarray(wa)))
    got = ops.cost_reduce(x, w)
    assert got.shape == (x.shape[0], 9) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# the sweep's class calls (B configs, E = 2G stacked busy rows, K slots),
# the PR-13 rows at B = 64, the large-batch row and the reference's shapes
SPLITS = {
    (1, 4, 4189): (33, 4), (3, 4, 4189): (33, 4), (18, 4, 4189): (33, 4),
    (3, 12, 4191): (33, 8), (64, 2, 4189): (33, 4), (64, 6, 4191): (33, 8),
    (1024, 12, 4191): (3, 8), (3, 48, 4000): (32, 8),
    (1, 1, 1): (1, 4), (4, 7, 33): (1, 8), (128, 128, 128): (1, 8),
    (130, 257, 140): (1, 8), (2, 3, 0): (1, 4),
}


@pytest.mark.parametrize("shape", list(SPLITS), ids=lambda s: "x".join(
    map(str, s)))
def test_split_rule(shape):
    """``_split`` pinned: at the sweep's batches T is cut into 33 slices of
    128 terms, at B in the thousands into few; every slice is whole granules
    and none is empty; a grid cut into slices stays within one wave."""
    b, e, t = shape
    slices, e_tile = cr._split(b, e, t)
    assert (slices, e_tile) == SPLITS[shape]
    length = cr.slice_len(t, slices)
    assert length % cr.GRANULE == 0
    assert slices * length >= t and (slices - 1) * length < max(t, 1)
    assert e_tile in cr.E_TILES and (e_tile >= e or e_tile == 8)
    warps = cr._warps(b)
    assert 1 <= warps <= cr.MAX_WARPS
    blocks = slices * -(-b // (cr.ROWS * warps)) * -(-e // e_tile)
    assert slices == 1 or blocks <= cr.WAVE_BLOCKS


@pytest.mark.parametrize("b,e,t,slices", [(1, 4, 4189, 33), (3, 12, 4191, 33),
                                          (18, 4, 4189, 33), (5, 3, 300, 2),
                                          (4, 7, 33, 1)])
def test_cost_reduce_split_plain(b, e, t, slices):
    """The kernel's order (slice partials, then the slices in order) is the
    same function: against the plain version in float64 (1e-12 of
    sum |x||w|), against the Pallas kernel in interpret mode in float32
    (the reference's 1e-4), and exact on integer count rows."""
    rng = np.random.RandomState(b * 7 + e)
    xa = rng.uniform(0.0, 1e-3, (b, t))
    wa = _busy_rows(rng, e, t)
    x, w = torch.from_numpy(xa), torch.from_numpy(wa)
    got = cr.cost_reduce_split_plain(x, w, slices)
    scale = (x.abs() @ w.abs().T).numpy()
    assert np.all(np.abs(got.numpy() - cr.cost_reduce_plain(x, w).numpy())
                  <= 1e-12 * scale)
    x32, w32 = xa.astype(np.float32), wa.astype(np.float32)
    want = jax_cost_reduce_bet(to_jax(x32), to_jax(w32), interpret=True)
    got32 = cr.cost_reduce_split_plain(to_torch(x32), to_torch(w32), slices)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    xi = torch.from_numpy(rng.randint(0, 1000, (b, t)).astype(np.float64))
    wi = torch.from_numpy(rng.randint(0, 3, (e, t)).astype(np.float64))
    assert torch.equal(cr.cost_reduce_split_plain(xi, wi, slices),
                       xi @ wi.T)
