"""MLA's absorbed decode (``models/layers.py:_mla_absorbed``) on the CPU:
DeepSeek-V2's smoke spec in float32, where ``attention_impl="cuda"`` takes
the absorbed path (the flash entry's plain version) and ``"naive"`` the
recompute one (k and v of every head from the whole latent cache).

The absorbed path is held to the recompute path and to a float32 full
forward over each slot's history, step by step, through ``decode_step`` and
through the engine with slots turning over.  The routing runs at a capacity
that drops no pick, so a token's route does not depend on which tokens it is
dispatched with.  ``LOGIT_TOL``: both paths compute the same products in
another order (q . W_uk . c against q . (W_uk . c)), so float32 logits of
order 1 differ by rounding, about 1e-6; a latent or an absorbed query
rounded to bfloat16 once moves them by 1e-3 and more (checked below).  The
flash entry's plain version at the MLA instance's shapes is held to float64,
and the instance's routing and refusals to their rules."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import RuntimeCfg, init_cache, init_params, lm
from repro_torch.models import layers as L
from repro_torch.obs import metrics, spans
from repro_torch.serve import Engine, Request

SPEC = get("deepseek-v2-236b").smoke
F32 = dict(param_dtype="float32", compute_dtype="float32", moe_capacity=64.0)
ABSORBED = RuntimeCfg(attention_impl="cuda", **F32)
RECOMPUTE = RuntimeCfg(attention_impl="naive", **F32)
LOGIT_TOL = 2e-5


@pytest.fixture(autouse=True)
def _clean_obs():
    spans.disable()
    metrics.reset()
    yield
    spans.disable()
    metrics.reset()


@pytest.fixture(scope="module")
def params():
    return init_params(SPEC, ABSORBED, device="cpu", seed=0)


def _counts() -> dict:
    snap = metrics.REGISTRY.collect()["counters"]
    return {k: v for k, v in snap.items() if k.startswith("mla.") and v}


def _close(got, want, tol=LOGIT_TOL) -> float:
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err
    return err


def _decode(params, rt, tokens, cache=None):
    """Logits [B, steps, V] of single-token decode steps over ``tokens``."""
    cache = cache or init_cache(SPEC, rt, tokens.shape[0], 16, device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = lm.decode_step(params, cache, tokens[:, t:t + 1],
                                       SPEC, rt)
        out.append(logits[:, 0])
    return torch.stack(out, 1), cache


def _forward(params, tokens):
    """The float32 full forward's logits over each row's history."""
    return lm.forward(params, tokens, SPEC, RECOMPUTE)


def _tokens(seed, b, s):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        1, SPEC.vocab, size=(b, s)))


@pytest.mark.parametrize("steps", [1, 3])
def test_decode_steps_against_recompute_and_full_forward(params, steps):
    tok = _tokens(steps, 3, steps)
    got, _ = _decode(params, ABSORBED, tok)
    want, _ = _decode(params, RECOMPUTE, tok)
    assert torch.isfinite(got).all()
    _close(got, want)
    _close(got, _forward(params, tok))


def _served(params, rt, n_requests: int):
    """Requests of 3-5 prompt and 3-4 new tokens over 2 slots -> (tokens by
    request, each step's fed tokens [2, 1] and logits [2, V])."""
    eng = Engine(SPEC, rt, params, batch_slots=2, kv_len=32, device="cpu")
    steps, inner = [], eng.step_fn

    def recorded(p, cache, tok):
        logits, cache = inner(p, cache, tok)
        steps.append((tok.clone(), logits[:, 0].clone()))
        return logits, cache

    eng.step_fn = recorded
    rng = np.random.RandomState(7)
    for rid in range(n_requests):
        eng.submit(Request(rid=rid, prompt=rng.randint(
            1, SPEC.vocab, size=3 + rid % 3), max_new=3 + rid % 2))
    done = {r.rid: list(r.out) for r in eng.run(max_steps=64)}
    return done, steps


@pytest.mark.parametrize("n_requests", [2, 5], ids=["one-fill", "turnover"])
def test_engine_against_recompute_and_full_forward(params, n_requests):
    """Tokens equal, every step's logits within LOGIT_TOL of the recompute
    engine's and of the full forward over the slots' fed tokens (with
    turnover a slot's later request attends to what the earlier ones
    wrote, as the cache is never reset)."""
    got, got_steps = _served(params, ABSORBED, n_requests)
    want, want_steps = _served(params, RECOMPUTE, n_requests)
    assert sorted(got) == list(range(n_requests)) and got == want
    fed = torch.cat([tok for tok, _ in got_steps], dim=1)          # [2, T]
    full = _forward(params, fed)
    for t, ((tok, lg), (tok_r, lg_r)) in enumerate(zip(got_steps,
                                                       want_steps)):
        assert torch.equal(tok, tok_r)
        _close(lg, lg_r)
        _close(lg, full[:, t])


def _rounded_to_bf16(monkeypatch, what: str):
    """The absorbed path with its latent rows or its query rounded to
    bfloat16 once (a float32 run that computed in a lower precision)."""
    if what == "latent":
        real = L._latent_buffer

        def latent(ckv, kr):
            return real(ckv, kr).to(torch.bfloat16).float()
        monkeypatch.setattr(L, "_latent_buffer", latent)
    else:
        real = ops.flash_attention

        def attend(q, k, v, **kw):
            return real(q.to(torch.bfloat16).float(), k, v, **kw)
        monkeypatch.setattr(ops, "flash_attention", attend)


@pytest.mark.parametrize("what", ["latent", "query"])
def test_the_tolerance_catches_bf16_rounding(params, monkeypatch, what):
    tok = _tokens(11, 3, 3)
    want, _ = _decode(params, RECOMPUTE, tok)
    _rounded_to_bf16(monkeypatch, what)
    got, _ = _decode(params, ABSORBED, tok)
    assert (got - want).abs().max().item() > 10 * LOGIT_TOL


def _separate(cache: dict) -> dict:
    """The cache with ckv and kr as tensors of their own (no latent
    buffer), as the parent's ``init_cache`` made them."""
    def fix(c):
        if isinstance(c, dict) and "ckv" in c:
            return {**c, "ckv": c["ckv"].clone(), "kr": c["kr"].clone()}
        return c
    return {"prefix": [{k: fix(v) for k, v in c.items()}
                       for c in cache["prefix"]],
            "slots": [{k: fix(v) for k, v in c.items()}
                      for c in cache["slots"]]}


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_latent_views_leave_the_recompute_path_bit_for_bit(params, impl):
    """The recompute path reads the same numbers from the latent buffer's
    views as from separate ckv / kr tensors."""
    rt = dataclasses.replace(ABSORBED, attention_impl=impl, attn_chunk=4)
    tok = _tokens(5, 2, 4)
    views = init_cache(SPEC, rt, 2, 16, device="cpu")
    assert views["prefix"][0]["attn"]["kr"].data_ptr() == \
        views["prefix"][0]["attn"]["ckv"].data_ptr() + 4 * SPEC.mla.kv_lora
    apart = _separate(init_cache(SPEC, rt, 2, 16, device="cpu"))
    with spans.profiled():
        got, gc = _decode(params, rt, tok, apart)
    assert _counts() == {"mla.decode_recompute": 4 * SPEC.n_layers}
    want, wc = _decode(params, rt, tok, views)
    assert torch.equal(got, want)
    for a, b in zip(gc["prefix"] + gc["slots"], wc["prefix"] + wc["slots"]):
        assert torch.equal(a["attn"]["ckv"], b["attn"]["ckv"])
        assert torch.equal(a["attn"]["kr"], b["attn"]["kr"])


@pytest.mark.parametrize("apart", ["ckv", "kr"])
def test_the_absorbed_path_refuses_a_cache_without_the_latent_buffer(
        params, apart):
    """Under the absorbed path's rule a decode step reads ckv and kr as
    views of one latent buffer; a cache that holds either as a tensor of its
    own raises by name, and nothing falls back to the recompute path."""
    cache = init_cache(SPEC, ABSORBED, 2, 16, device="cpu")["prefix"][0]
    layer = {**cache["attn"], apart: cache["attn"][apart].clone()}
    with spans.profiled(), \
            pytest.raises(ValueError, match="one .* latent buffer"):
        L.mla_attention(params["prefix"][0]["attn"],
                        torch.randn(2, 1, SPEC.d_model), SPEC, ABSORBED,
                        cache=layer)
    assert _counts() == {"mla.decode_absorbed": 1}


def test_the_counters_count_by_path(params):
    """Per decode call: one of the two path counters; the absorbed one adds
    batch x keys to ``mla.latent_rows``.  A prefill counts nothing; with
    tracing off nothing is counted."""
    tok = _tokens(3, 2, 3)
    _decode(params, ABSORBED, tok)
    assert _counts() == {}
    with spans.profiled() as prof:
        _decode(params, ABSORBED, tok)
        _decode(params, RECOMPUTE, tok[:, :2])
        lm.forward(params, tok, SPEC, ABSORBED)
    n = SPEC.n_layers
    assert _counts() == {"mla.decode_absorbed": 3 * n,
                         "mla.decode_recompute": 2 * n,
                         "mla.latent_rows": 2 * (1 + 2 + 3) * n}
    names = {e.name for e in prof.events}
    assert {"mla.absorb", "mla.attend", "model.mla"} <= names


def test_a_several_token_step_recomputes(params):
    cache = init_cache(SPEC, ABSORBED, 2, 16, device="cpu")
    with spans.profiled():
        lm.decode_step(params, cache, _tokens(2, 2, 3), SPEC, ABSORBED)
    assert _counts() == {"mla.decode_recompute": SPEC.n_layers}


@pytest.mark.parametrize("where", ["meta", "fake"])
def test_meta_and_fake_tensors_recompute(params, where):
    """The dry run's tensors take the recompute path, whatever the impl."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    p = params["prefix"][0]["attn"]
    with spans.profiled():
        if where == "meta":
            cache = init_cache(SPEC, ABSORBED, 2, 8, device="meta")
            x = torch.zeros(2, 1, SPEC.d_model, device="meta")
            # the recompute path's kernel entry takes no meta tensor, as
            # before the absorbed path existed
            with pytest.raises(ValueError, match="not on meta"):
                L.mla_attention({k: v.to("meta") for k, v in p.items()}, x,
                                SPEC, ABSORBED,
                                cache=cache["prefix"][0]["attn"])
        else:
            mode = FakeTensorMode()
            pf = {k: mode.from_tensor(v) for k, v in p.items()}
            with mode:
                cache = init_cache(SPEC, ABSORBED, 2, 8, device="cpu")
                x = torch.zeros(2, 1, SPEC.d_model)
                L.mla_attention(pf, x, SPEC, ABSORBED,
                                cache=cache["prefix"][0]["attn"])
    assert _counts() == {"mla.decode_recompute": 1}


def test_training_recomputes_and_the_kernel_entry_refuses_grad(params):
    """With a weight that requires grad under grad mode the step takes the
    recompute path, whose kernel entry refuses to be differentiated, as
    before the absorbed path existed."""
    p = {k: v.clone().requires_grad_(True)
         for k, v in params["prefix"][0]["attn"].items()}
    cache = init_cache(SPEC, ABSORBED, 2, 8, device="cpu")["prefix"][0]["attn"]
    x = torch.randn(2, 1, SPEC.d_model)
    with spans.profiled(), pytest.raises(RuntimeError, match="no backward"):
        L.mla_attention(p, x, SPEC, ABSORBED, cache=cache)
    assert _counts() == {"mla.decode_recompute": 1}


# ---- the flash entry at the MLA instance's shapes --------------------------

def _mla_call(b=2, sk=40, g=128, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    latent = torch.randn((b, sk, 1, fa.MLA_D), generator=gen).to(dtype)
    q = torch.randn((b, 1, 1, g, fa.MLA_D), generator=gen).to(dtype)
    return q, latent, latent[..., :fa.MLA_DV]


@pytest.mark.parametrize("window", [None, 17])
def test_plain_mla_shape_against_float64(window):
    """D 576, Dv 512 (v the first 512 columns of k): fp32 within 1e-5 of
    float64, the same function in another order of sums."""
    q, k, v = _mla_call(sk=70)
    got = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                   q_offset=60)
    mask = fa._visible(1, 70, True, window, 60, "cpu")[0]
    s = torch.einsum("bnd,bkd->bnk", q[:, 0, 0].double(),
                     k[:, :, 0].double()) / math.sqrt(fa.MLA_D)
    s = s.masked_fill(~mask, float("-inf"))
    want = torch.einsum("bnk,bkd->bnd", torch.softmax(s, -1),
                        v[:, :, 0].double())
    assert got.shape == (2, 1, 1, 128, fa.MLA_DV)
    err = (got[:, 0, 0].double() - want).abs().max().item()
    assert err <= 1e-5, err


def test_variant_of_the_absorbed_call():
    q, k, v = _mla_call(dtype=torch.bfloat16)
    assert fa._variant(q, k, v) == "mla" and fa.mla_problems(q, k, v) == []
    # the recompute path's call stays on the decode kernel
    assert fa._variant(q[..., :192].contiguous(), k[..., :192].contiguous(),
                       v[..., :128].contiguous()) == "decode"


def _refused(q, k, v):
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype)
    before = fa.launches
    with pytest.raises(ValueError, match="MLA decode instance") as e:
        fa._launch(q, k, v, out, True, None, None, k.shape[1] - 1)
    assert fa.launches == before
    return str(e.value)


@pytest.mark.parametrize("bad,named", [
    ("fp32", "dtype"), ("fp16", "dtype"), ("kv-heads", "kv heads"),
    ("rows", "query rows"), ("v-apart", "leading columns"),
    ("dv", "head dims"),
])
def test_launch_refuses_what_the_instance_does_not_take(bad, named):
    q, k, v = _mla_call(dtype={"fp32": torch.float32, "fp16": torch.float16}
                        .get(bad, torch.bfloat16))
    if bad == "kv-heads":
        k = torch.cat([k, k], dim=2)
        v = k[..., :fa.MLA_DV]
        q = torch.cat([q, q], dim=2)
    elif bad == "rows":
        q = torch.cat([q, q], dim=1)
    elif bad == "v-apart":
        v = v.clone()
    elif bad == "dv":
        v = k[..., :256]
    assert named in _refused(q, k, v)


def test_launch_hands_the_instance_its_shape(monkeypatch):
    """The accepted call reaches the C entry as variant 3, 2 chunks of 64
    heads, the split of decode_splits over one wave of 132 blocks."""
    seen = {}

    def fake_fn(*args):
        seen["meta"] = list(args[4])
        seen["variant"], seen["scale"] = args[8], args[5]
        return 0
    monkeypatch.setattr(fa, "_kernel_fn", lambda: fake_fn)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(fa, "split_scratch", lambda *a: (1, 2))
    q, k, v = _mla_call(b=3, sk=3000, dtype=torch.bfloat16)
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype)
    fa._launch(q, k, v, out, True, None, None, 2999)
    meta = seen["meta"]
    splits = fa.decode_splits(3, 2, 3000, fa.MLA_TARGET_BLOCKS)
    assert seen["variant"] == 3 and meta[2] == 128 and meta[5] == fa.MLA_D
    assert meta[25] == 2 and meta[26] == fa.MLA_DV and meta[23] == splits > 1
    assert meta[24] == -(-3000 // splits)
    assert seen["scale"] == pytest.approx(1 / math.sqrt(fa.MLA_D))


@pytest.mark.parametrize("g", [8, 16, 96, 128])
def test_launch_hands_the_instance_any_head_count(monkeypatch, g):
    """Any G: ceil(G / 64) chunks of up to 64 heads, the split scratch
    holding 64 heads a chunk (the kernel's stride between heads' partial
    rows), and every launch counted under its variant."""
    seen = {}

    def fake_fn(*args):
        seen["meta"] = list(args[4])
        return 0

    def scratch(device, stream, nbytes, units):
        seen["scratch"] = nbytes, units
        return 1, 2
    monkeypatch.setattr(fa, "_kernel_fn", lambda: fake_fn)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(fa, "split_scratch", scratch)
    monkeypatch.setattr(fa, "launches_by_variant",
                        dict.fromkeys(fa.launches_by_variant, 0))
    q, k, v = _mla_call(b=2, sk=3000, g=g, dtype=torch.bfloat16)
    assert fa.mla_problems(q, k, v) == []
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype)
    fa._launch(q, k, v, out, True, None, None, 2999)
    chunks = -(-g // fa.MLA_HEADS)
    splits = fa.decode_splits(2, chunks, 3000, fa.MLA_TARGET_BLOCKS)
    assert seen["meta"][2] == g and seen["meta"][25] == chunks
    assert seen["meta"][23] == splits > 1
    assert seen["scratch"] == (4 * 2 * chunks * splits * fa.MLA_HEADS
                               * (fa.MLA_DV + 2), 2 * chunks)
    assert fa.launches_by_variant == {"fma": 0, "tc": 0, "decode": 0,
                                      "mla": 1}
