"""The tile algorithm of the port's wkv6 kernel, on the CPU.

``wkv6_tiled_plain`` is the ``tiled`` CUDA kernel's own arithmetic in fp32
PyTorch (running prefix and suffix products within a tile, tiles cut at chunk
boundaries, three accumulators carried).  It is held against ``wkv6_plain`` in
float64 under the limit ``chip_smoke.py`` holds the kernel to on the card,
2e-4 + 2e-4·|x|, on output and final state; and against the JAX package's
Pallas kernel in interpret mode and its exact recurrence ``ref_wkv`` at the
reference's shapes with the 1e-4 tolerance of ``test_torch_rwkv6.py``.  Also
here: the rule that names the kernel of a CUDA call (``_variant``), the tile
configuration, the wrapper's layout checks for the two kernels, bf16
r, k, v, the dtypes and head dims the wrapper takes as the reference does
(and the zero-pad rule of the card's instances), and the model's layer at a
float16 runtime."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ModelSpec as JaxModelSpec
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv6_bhsd as jax_wkv6_bhsd
from repro.models import layers as JL
from repro.models.common import Initializer as JaxInitializer
from repro.models.common import pvalue
from repro_torch import ModelSpec
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as W
from repro_torch.models import layers, params_from_reference
from torch_port_helpers import as_f32, runtimes, to_jax, to_torch

CHIP_TOL = dict(absolute=2e-4, relative=2e-4)     # chip_smoke.py's WKV_TOL
TOL = 1e-4                                        # test_torch_rwkv6.py's


def _inputs(seed, b, s, n, d, dec_scale=1.0, state=True):
    """Model-layout r/k/v/w [B,S,N,D], u [N,D], state0 [B,N,D,D] (torch
    float32) with decays w = exp(-exp(dec)), dec ~ dec_scale·N(0, 1)."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((b, s, n, d)) for _ in range(3))
    w = np.exp(-np.exp(dec_scale * rng.standard_normal((b, s, n, d))))
    u = rng.standard_normal((n, d))
    s0 = rng.standard_normal((b, n, d, d)) if state else np.zeros((b, n, d, d))
    return [to_torch(a.astype(np.float32)) for a in (r, k, v, w, u, s0)]


def _share_of_limit(got, want) -> float:
    """Largest |got - want| over the chip limit at ``want`` (float64)."""
    allowed = CHIP_TOL["absolute"] + CHIP_TOL["relative"] * want.abs()
    return ((got.double() - want).abs() / allowed).max().item()


def _hold(args, chunk, tile):
    got_o, got_s = W.wkv6_tiled_plain(*args, chunk=chunk, tile=tile)
    want_o, want_s = W.wkv6_plain(*args, chunk=chunk, dtype=torch.float64)
    assert got_o.dtype == torch.float32 and got_o.shape == args[0].shape
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    share = max(_share_of_limit(got_o, want_o), _share_of_limit(got_s, want_s))
    assert share <= 1.0, f"{share:.3f} of the chip limit"
    return share


# ---------------------------------------------------------------------------
# the tile algorithm against the float64 function, under the chip limit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("chunk,s", [(1, 5), (2, 64), (32, 128), (40, 80),
                                     (57, 114), (1000, 1000)])
def test_tiled_plain_within_chip_limit(chunk, s, tile):
    """Strong decays (dec ~ N(0,1): about a fifth of the decays below the
    C = 32 floor); ragged last tiles at C = 40, 57, 1000, tiles cut at every
    chunk boundary where C < L."""
    n = 2 if s < 1000 else 1
    _hold(_inputs(chunk * 10 + tile, 1, s, n, 32), chunk, tile)


@pytest.mark.parametrize("chunk,tile", [(32, 16), (57, 16), (8, 16),
                                        (1000, 32)])
def test_tiled_plain_decays_below_1e30(chunk, tile):
    """dec ~ 1.5·N(0,1) gives decays below 1e-30 (the true-decay products
    underflow); one more is set at the first step of a tile and one at a
    chunk's first step."""
    s = 2 * chunk if chunk < 1000 else chunk
    args = _inputs(7, 2, s, 2, 16, dec_scale=1.5)
    w = args[3]
    w[0, min(tile, chunk), 0] = 1e-35      # first step of the second tile
    w[1, 0, 1] = 1e-38                     # first step of the sequence
    assert int((w < 1e-30).sum()) >= 3
    _hold(args, chunk, tile)


@pytest.mark.parametrize("chunk,tile", [(32, 16), (57, 32)])
def test_tiled_plain_state_carried_across_two_calls(chunk, tile):
    """Two calls with the state carried == one call over both halves (the
    halves start on chunk boundaries), and the second call is within the
    chip limit of the float64 function on the carried state."""
    r, k, v, w, u, s0 = _inputs(11, 2, 2 * chunk, 2, 32)
    o1, st1 = W.wkv6_tiled_plain(*(t[:, :chunk] for t in (r, k, v, w)), u, s0,
                                 chunk=chunk, tile=tile)
    second = [t[:, chunk:] for t in (r, k, v, w)]
    o2, st2 = W.wkv6_tiled_plain(*second, u, st1, chunk=chunk, tile=tile)
    full_o, full_s = W.wkv6_tiled_plain(r, k, v, w, u, s0, chunk=chunk,
                                        tile=tile)
    assert torch.equal(torch.cat([o1, o2], dim=1), full_o)
    assert torch.equal(st2, full_s)
    _hold([*second, u, st1], chunk, tile)


def test_tile_length_does_not_change_the_function():
    """The tile is the kernel's choice, the chunk is part of the result:
    every tile length gives the same function within fp32 rounding, and a
    different chunk gives a different one."""
    args = _inputs(12, 1, 96, 2, 32)
    outs = [W.wkv6_tiled_plain(*args, chunk=32, tile=t)[0] for t in (8, 16, 32)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-4,
                                   rtol=1e-4)
    other = W.wkv6_tiled_plain(*args, chunk=96, tile=16)[0]
    assert (other - outs[0]).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# against the JAX package: Pallas in interpret mode, and ref_wkv
# ---------------------------------------------------------------------------

def _bhsd_inputs(seed, b, h, s, d, decays):
    """test_torch_rwkv6.py's inputs: r/k/v/w [B,H,S,D], u [H,D], state0
    [B,H,D,D] as float32 numpy, mild (dec ~ U(-2, 0.5)) or strong decays."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    dec = rng.uniform(-2.0, 0.5, (b, h, s, d)) if decays == "mild" \
        else rng.standard_normal((b, h, s, d))
    w = np.exp(-np.exp(dec)).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.5).astype(np.float32)
    return r, k, v, w, u, s0


def _tiled_bhsd(r, k, v, w, u, s0, chunk, tile=16):
    """wkv6_tiled_plain on [B,H,S,D] numpy -> (out [B,H,S,D], state)."""
    ml = [to_torch(a.transpose(0, 2, 1, 3)) for a in (r, k, v, w)]
    out, state = W.wkv6_tiled_plain(*ml, to_torch(u), to_torch(s0),
                                    chunk=chunk, tile=tile)
    return out.transpose(1, 2), state


REF_SHAPES = [(1, 1, 64, 32, 32), (2, 2, 128, 64, 32), (1, 3, 96, 48, 32)]


@pytest.mark.parametrize("decays", ["mild", "strong"])
@pytest.mark.parametrize("b,h,s,d,chunk", REF_SHAPES)
def test_tiled_plain_vs_pallas_interpret(b, h, s, d, chunk, decays):
    args = _bhsd_inputs(3, b, h, s, d, decays)
    want_o, want_s = jax_wkv6_bhsd(*(to_jax(a) for a in args), chunk=chunk,
                                   interpret=True)
    got_o, got_s = _tiled_bhsd(*args, chunk)
    np.testing.assert_allclose(as_f32(got_o), as_f32(want_o), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(as_f32(got_s), as_f32(want_s), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,h,s,d,chunk", REF_SHAPES)
def test_tiled_plain_vs_ref_wkv(b, h, s, d, chunk):
    """Mild decays never reach the floor: the tile algorithm is the exact
    recurrence of the JAX package's ``ref_wkv``.  With strong decays the
    final state still is (it carries the true decay)."""
    for decays in ("mild", "strong"):
        args = _bhsd_inputs(4, b, h, s, d, decays)
        want_o, want_s = jref.ref_wkv(*(to_jax(a) for a in args))
        got_o, got_s = _tiled_bhsd(*args, chunk)
        np.testing.assert_allclose(as_f32(got_s), as_f32(want_s), atol=TOL,
                                   rtol=TOL)
        if decays == "mild":
            np.testing.assert_allclose(as_f32(got_o), as_f32(want_o),
                                       atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the rule, the tile configuration and the layout checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,want", [(1, "decode"), (2, "tiled"),
                                    (40, "tiled"), (2048, "tiled")])
def test_variant_rule(s, want):
    assert W._variant(torch.zeros(2, s, 3, 16)) == want


def test_variant_of_the_served_calls():
    """The engine's decode step (one token, C = 1) goes to decode; a prompt
    and the [2, 2048] prefill go to tiled; the TPU layout's transposed view
    keeps its sequence axis."""
    assert W._variant(torch.zeros(8, 1, 64, 64)) == "decode"
    assert W._variant(torch.zeros(2, 2048, 64, 64)) == "tiled"
    assert W._variant(torch.zeros(1, 37, 64, 64)) == "tiled"
    bhsd = torch.zeros(2, 4, 1, 32)
    assert W._variant(bhsd.transpose(1, 2)) == "decode"


def test_tile_config():
    """Chunks of at most 32 at head dims 32 and 64: one tile per chunk over
    all columns (the one-accumulator kernel); else 16 steps x 32 columns at
    head dim 64 and 16 x 16 at the others (head dim 128 included)."""
    for d in (32, 64):
        for chunk in (1, 8, 32):
            assert W.tile_config(d, chunk) == (0, d)
    assert W.tile_config(64, 40) == (16, 32)
    assert W.tile_config(64, 1000) == (16, 32)
    for d, chunk in ((16, 32), (48, 32), (32, 57), (16, 1000), (128, 32),
                     (128, 1)):
        assert W.tile_config(d, chunk) == (16, 16)


def _layout(t):
    return t.stride(), t.data_ptr(), t.element_size()


@pytest.mark.parametrize("case", ["strided_head_dim", "bf16_odd_stride",
                                  "bf16_misaligned", "decode_state_misaligned"])
def test_layout_checks_refuse(case):
    if case == "strided_head_dim":
        t = torch.zeros(1, 4, 2, 32)[..., ::2]
        args, variant = ("r", *_layout(t)), "tiled"
    elif case == "bf16_odd_stride":
        t = torch.zeros(1, 4, 2, 33, dtype=torch.bfloat16)[..., :32]
        args, variant = ("k", *_layout(t)), "tiled"
    elif case == "bf16_misaligned":
        t = torch.zeros(1 + 4 * 2 * 32, dtype=torch.bfloat16)[1:]
        t = t.view(1, 4, 2, 32)
        args, variant = ("v", *_layout(t)), "tiled"
    else:
        t = torch.zeros(1 + 2 * 16 * 16)[1:].view(1, 2, 16, 16)
        args, variant = ("state0", *_layout(t)), "decode"
    with pytest.raises(ValueError):
        W._check_layout(*args, variant)


def test_layout_checks_accept_the_served_layouts():
    """The model's heads (contiguous [B,S,N,D], fp32 or bf16), the TPU
    layout's transposed views, odd-offset fp32 views (read by elements) and
    a decode cache all pass for both kernels."""
    ml = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    bhsd = torch.zeros(2, 4, 16, 64).transpose(1, 2)
    odd = torch.zeros(1 + 2 * 16 * 4 * 64)[1:].view(2, 16, 4, 64)
    cache = torch.zeros(8, 64, 64, 64)
    for variant in ("tiled", "decode"):
        for name, t in (("r", ml), ("w", bhsd), ("out", bhsd), ("k", odd),
                        ("state0", cache), ("state_out", cache)):
            W._check_layout(name, *_layout(t), variant)


def test_cpu_never_launches():
    before, by_variant = W.launches, dict(W.launches_by_variant)
    args = _inputs(13, 1, 4, 1, 16)
    ops.wkv6(*args, chunk=2)
    ops.wkv6(*(a[:, :1] for a in args[:4]), *args[4:], chunk=1)
    assert W.launches == before and W.launches_by_variant == by_variant


# ---------------------------------------------------------------------------
# bf16 r, k, v
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(1, 1), (64, 32), (40, 40)])
def test_bf16_inputs_equal_their_fp32_casts(s, chunk):
    """r, k, v in bf16 give the same output and state, bit for bit, as
    their exact fp32 casts (the kernel casts on load as the TPU kernel does,
    so the model hands them over without copies)."""
    r, k, v, w, u, s0 = _inputs(14, 2, s, 2, 32)
    rb, kb, vb = (t.bfloat16() for t in (r, k, v))
    got = ops.wkv6(rb, kb, vb, w, u, s0, chunk=chunk)
    want = ops.wkv6(rb.float(), kb.float(), vb.float(), w, u, s0, chunk=chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.float32
    tiled = W.wkv6_tiled_plain(rb, kb, vb, w, u, s0, chunk=chunk, tile=16)
    tiled_f = W.wkv6_tiled_plain(rb.float(), kb.float(), vb.float(), w, u, s0,
                                 chunk=chunk, tile=16)
    assert torch.equal(tiled[0], tiled_f[0])


def _pallas(r, k, v, w, u, s0, chunk):
    """The JAX package's Pallas kernel (interpret mode) on the port's
    model-layout tensors, each in its own dtype (float64 ones as the float32
    values they hold) -> (out, state) as float32 numpy, model layout."""
    def jx(t, bhsd=False):
        a = t.float().numpy()
        name = str(t.dtype)[6:]
        return to_jax(a.transpose(0, 2, 1, 3) if bhsd else a,
                      "float32" if name == "float64" else name)
    out, state = jax_wkv6_bhsd(*(jx(t, True) for t in (r, k, v, w)), jx(u),
                               jx(s0), chunk=chunk, interpret=True)
    return as_f32(out).transpose(0, 2, 1, 3), as_f32(state)


@pytest.mark.parametrize("bad", ["mixed", "float16", "w_bf16", "state_bf16",
                                 "int", "in_place_bf16_state"])
def test_dtypes_refused(bad):
    """Integer inputs, and an in-place update of a state that is not
    float32, are refused.  Mixed r/k/v, float16 r/k/v and bf16 w or state,
    refused before, now give the reference's result: its Pallas kernel casts
    every input to fp32 on load (interpret mode, 1e-4)."""
    r, k, v, w, u, s0 = _inputs(15, 1, 4, 2, 16)
    if bad == "mixed":
        v = v.bfloat16()
    elif bad == "float16":
        r, k, v = (t.half() for t in (r, k, v))
    elif bad == "w_bf16":
        r, k, v, w = (t.bfloat16() for t in (r, k, v, w))
    elif bad == "state_bf16":
        s0 = s0.bfloat16()
    elif bad == "int":
        with pytest.raises(TypeError):
            ops.wkv6(r, k, v, w.long(), u, s0, chunk=2)
        return
    else:
        s0 = s0.bfloat16()
        with pytest.raises(TypeError, match="in place"):
            ops.wkv6(r, k, v, w, u, s0, chunk=2, state_out=s0)
        return
    out, state = ops.wkv6(r, k, v, w, u, s0, chunk=2)
    assert out.dtype == state.dtype == torch.float32
    want_o, want_s = _pallas(r, k, v, w, u, s0, chunk=2)
    np.testing.assert_allclose(as_f32(out), want_o, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(as_f32(state), want_s, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [8, 24, 40, 96])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_any_dtype_and_head_dim_vs_pallas_interpret(dtype, d):
    """Every input in float16 or float64 and head dims that are no kernel
    instance: the wrapper (the plain version here) against the Pallas kernel
    in interpret mode, which pads D to 128, on the same values (1e-4).
    On the card D = 96 runs at the head-dim-128 instance, zero-padded (see
    ``test_zero_pad_rule``)."""
    args = [t.to(dtype) for t in _inputs(16, 2, 64, 2, d)]
    out, state = ops.wkv6(*args, chunk=32)
    assert out.dtype == state.dtype == torch.float32
    assert out.shape == args[0].shape and state.shape == args[5].shape
    want_o, want_s = _pallas(*args, chunk=32)
    np.testing.assert_allclose(as_f32(out), want_o, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(as_f32(state), want_s, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [8, 24, 40, 63, 65, 96, 100])
def test_zero_pad_rule(d):
    """The card runs a head dim that is no instance at the next one, the
    inputs zero-padded and w padded with 1: the plain version at the padded
    width gives the unpadded result in the first D rows and columns, and
    zeros in the padded ones.  65-127 pad to the head-dim-128 instance;
    above 128 the card runs the head-dim-128 instance on 128 x 128 blocks
    of D zero-padded to a multiple of 128 (``test_blocked_*``)."""
    args = _inputs(17, 2, 40, 2, d)
    d_pad = W.head_dim_instance(d)
    assert d_pad == min(h for h in W.HEAD_DIMS if h >= d) > d
    padded = W.pad_head_dim(*args, d_pad)
    assert padded[3][..., d:].eq(1.0).all()
    f64 = torch.float64          # so that only the order of sums differs
    got_o, got_s = W.wkv6_plain(*padded, chunk=8, dtype=f64)
    want_o, want_s = W.wkv6_plain(*args, chunk=8, dtype=f64)
    np.testing.assert_allclose(got_o[..., :d].numpy(), want_o.numpy(),
                               atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(got_s[..., :d, :d].numpy(), want_s.numpy(),
                               atol=1e-10, rtol=1e-10)
    assert not got_o[..., d:].any() and not got_s[..., d:, :].any() \
        and not got_s[..., :, d:].any()
    for inst in W.HEAD_DIMS:
        assert W.head_dim_instance(inst) == inst
    assert W.HEAD_DIMS[-1] == 128
    for mid in (65, 96, 127):
        assert W.head_dim_instance(mid) == 128
    for big, blocks in ((129, 2), (192, 2), (256, 2), (257, 3)):
        assert W.head_dim_instance(big) == 128
        assert W.head_dim_blocks(big) == blocks
    assert W.head_dim_blocks(128) == 1


# ---------------------------------------------------------------------------
# head dims above 128: blocks of the D = 128 instance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [192, 256])
def test_blocked_plain_vs_plain_and_pallas(d):
    """The block decomposition the card runs above head dim 128 (D padded
    to m·128, the m x m (key-row block, value-column block) pairs as heads
    of D = 128, the partial outputs added over the row blocks), around the
    plain version: against ``wkv6_plain`` at D and against the Pallas kernel
    in interpret mode, with strong decays (dec ~ 2·N(0, 1): a fifth below
    the C = 16 floor), at the port's 1e-4."""
    args = _inputs(18, 2, 32, 2, d, dec_scale=2.0)
    got_o, got_s = W.wkv6_blocked_plain(*args, chunk=16)
    assert got_o.shape == args[0].shape and got_s.shape == args[5].shape
    assert (args[3] < np.exp(-80.0 / 16)).float().mean() > 0.15
    want_o, want_s = W.wkv6_plain(*args, chunk=16)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), atol=TOL,
                               rtol=TOL)
    pal_o, pal_s = _pallas(*args, chunk=16)
    np.testing.assert_allclose(got_o.numpy(), pal_o, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_s.numpy(), pal_s, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d,s,chunk", [(192, 32, 16), (256, 1, 1)],
                         ids=["tiled-d192", "decode-d256-in-place"])
def test_blocked_launch_path(monkeypatch, d, s, chunk):
    """The card's path above head dim 128 (``_launch_blocked``), with the
    launch replaced by the plain version at D = 128: one launch of N·m·m
    heads of head dim 128, whose results the wrapper puts back into ``out``
    and, for an in-place call, into ``state0`` itself; against
    ``wkv6_plain`` in float64 under the chip limit."""
    calls = []

    def launch(r, k, v, w, u, state0, out, state_out, chunk):
        calls.append(tuple(r.shape))
        assert r.shape[-1] == 128 and state0.shape[-2:] == (128, 128)
        assert all(t.is_contiguous() for t in (r, k, v, w, u, state0))
        got_o, got_s = W.wkv6_plain(r, k, v, w, u, state0, chunk=chunk)
        out.copy_(got_o)
        state_out.copy_(got_s)
    monkeypatch.setattr(W, "_launch", launch)
    args = _inputs(19, 2, s, 3, d, dec_scale=2.0)
    cache = args[5].clone()
    out = torch.empty(args[0].shape)
    W._launch_blocked(*args[:5], cache, out, cache, chunk)
    m = W.head_dim_blocks(d)
    assert calls == [(2, s, 3 * m * m, 128)]
    want_o, want_s = W.wkv6_plain(*args, chunk=chunk, dtype=torch.float64)
    assert max(_share_of_limit(out, want_o),
               _share_of_limit(cache, want_s)) <= 1.0


# ---------------------------------------------------------------------------
# the model's layer at a compute dtype the kernel does not read
# ---------------------------------------------------------------------------

LAYER_KW = dict(name="t", n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                d_ff=96, vocab=64, d_head=32, block="rwkv6",
                rwkv_decay_rank=8)


@pytest.mark.parametrize("steps", [[40], [1, 1, 3, 1]])
def test_rwkv6_layer_float16_runtime(steps):
    """A float16 runtime: wkv6 takes the layer's float16 r, k, v as fp32
    (the kernel reads bf16 and fp32 only) and the layer agrees with the JAX
    layer at float16, in a prefill and in decode steps through a cache."""
    jspec, tspec = JaxModelSpec(**LAYER_KW), ModelSpec(**LAYER_KW)
    jp = JL.init_rwkv6(JaxInitializer(jax.random.PRNGKey(3), "float16"),
                       jspec)
    tp = params_from_reference(jax.tree.map(np.asarray, pvalue(jp)),
                               device="cpu")
    jrt, trt = runtimes("float16")
    b, H, nh, dh = 2, tspec.d_model, tspec.n_heads, tspec.head_dim
    cached = len(steps) > 1
    jcache = {"wkv": jnp.zeros((b, nh, dh, dh), jnp.float32),
              "shift_tm": jnp.zeros((b, H), jnp.float16),
              "shift_cm": jnp.zeros((b, H), jnp.float16)} if cached else None
    tcache = {"wkv": torch.zeros(b, nh, dh, dh),
              "shift_tm": torch.zeros(b, H, dtype=torch.float16),
              "shift_cm": torch.zeros(b, H, dtype=torch.float16)} \
        if cached else None
    for i, s in enumerate(steps):
        a = np.random.RandomState(20 + i).standard_normal(
            (b, s, H)).astype(np.float32)
        jx, tx = to_jax(a, "float16"), to_torch(a, "float16")
        want, jcache = JL.rwkv6_layer(jp, jx, jspec, jrt, None, cache=jcache)
        got, tcache = layers.rwkv6_layer(tp, tx, tspec, trt, cache=tcache)
        assert got.dtype == torch.float16 and got.shape == tx.shape
        np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-2,
                                   rtol=1e-2)
