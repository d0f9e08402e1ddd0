"""The port's training pieces against the JAX package's on the CPU: chunked
attention (values and gradients), the RWKV6 chunk, AdamW and its schedule,
top-k compression, the train step, the data pipeline, the gradient rules
at ties, and the kernels' refusal to be differentiated.

Inputs come from numpy with a seed and go to both packages; the reference's
calls are jitted.  Tolerances, each stated where it is used: values of
fp32 attention 2e-5 (the reference's flash tolerance), gradients within
1e-4 * max|reference| + 1e-6 (the same arithmetic in another order of
sums), optimizer state 1e-6 relative."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ModelSpec as JaxModelSpec
from repro.data import DataCfg as JaxDataCfg
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.models import layers as JL
from repro.models.common import Param, pvalue
from repro.train import OptCfg as JaxOptCfg
from repro.train import adamw_update as jax_adamw_update
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import topk_compress_decompress as jax_topk
from repro.train.optimizer import schedule as jax_schedule
from repro_torch import ModelSpec
from repro_torch.configs import get
from repro_torch.data import DataCfg, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels.cost_reduce import cost_reduce_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels import selective_scan as SS
from repro_torch.kernels.rwkv6_scan import wkv6_plain
from repro_torch.models import RuntimeCfg, init_params, layers as TL, lm
from repro_torch.serve.engine import make_prefill
from repro_torch.train import (OptCfg, adamw_update, init_opt_state,
                               make_train_step, topk_compress_decompress)
from repro_torch.train.optimizer import schedule
from repro_torch.train.tree import leaves
from torch_port_helpers import (as_f32, assert_grads_close, runtimes,
                                shared_params)

# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

# (id, b, sq, sk, n, g, d, dv, causal, window, softcap, chunk, q_block,
#  q_offset)
ATTN_CASES = [
    ("causal-q-blocked", 2, 32, 32, 2, 3, 16, 16, True, None, None, 8, True,
     0),
    ("window", 2, 32, 32, 2, 2, 16, 16, True, 5, None, 8, True, 0),
    ("softcap", 2, 24, 24, 2, 2, 16, 16, True, None, 5.0, 8, True, 0),
    ("sk-within-chunk", 2, 12, 12, 2, 2, 16, 16, True, None, None, 16, True,
     0),
    ("no-q-block", 2, 32, 32, 2, 2, 16, 16, True, None, None, 8, False, 0),
    ("ragged-sk", 2, 20, 20, 2, 2, 16, 16, True, None, None, 8, True, 0),
    ("mla-dv-below-d", 2, 32, 32, 4, 1, 24, 16, True, None, None, 8, True,
     0),
    # queries in blocks over keys shorter than a chunk: the reference's
    # blocks carry traced offsets and so skip the naive shortcut
    ("cross-short-kv", 2, 32, 6, 2, 2, 16, 16, False, None, None, 8, True,
     0),
    ("q-offset", 1, 4, 20, 2, 2, 16, 16, True, None, None, 8, True, 16),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attn_chunked_values_and_grads(case):
    """``attn_core`` with ``"chunked"`` (the port's checkpointed
    ``attn_chunked``) against the reference's: the output within 2e-5, the
    q, k, v gradients under a random cotangent within 1e-4 * max + 1e-6."""
    (_, b, sq, sk, n, g, d, dv, causal, window, softcap, chunk, q_block,
     q_offset) = case
    rng = np.random.RandomState(0)
    q = rng.standard_normal((b, sq, n, g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, n, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, n, dv)).astype(np.float32)
    ct = rng.standard_normal((b, sq, n, g, dv)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    jrt, trt = runtimes(impl="chunked")
    jrt = dataclasses.replace(jrt, attn_chunk=chunk, attn_q_block=q_block)
    trt = dataclasses.replace(trt, attn_chunk=chunk, attn_q_block=q_block)

    @jax.jit
    def reference(q, k, v, ct):
        out, vjp = jax.vjp(lambda *a: JL.attn_core(*a, jrt, **kw), q, k, v)
        return out, vjp(ct)

    want, want_g = reference(q, k, v, ct)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = TL.attn_core(tq, tk, tv, trt, **kw)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=2e-5,
                               rtol=2e-5)
    assert_grads_close([t.grad.numpy() for t in (tq, tk, tv)],
                       [np.asarray(a) for a in want_g])


def test_attn_chunked_equals_naive_values():
    """The online softmax is the softmax: against the port's naive core."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.standard_normal((2, 32, 2, 2, 16))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 32, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(causal=True, window=9, softcap=None)
    got = TL.attn_chunked(q, k, v, chunk=8, **kw)
    want = TL.attn_naive(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the RWKV6 chunk and the Mamba scan under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strong", [False, True])
def test_wkv_chunk_values_and_grads(strong):
    """``_wkv_chunk`` against the reference's, one chunk of 16 with a state;
    ``strong`` decays (below the -80/C = -5 floor) take the
    floored factorisation.  Values and gradients of r, k, v, w, u and the
    state within 1e-4 * max + 1e-6.  The strong decays are log w in
    [-7, -5.5]: deeper ones make w's gradient (through 1/w) ill-conditioned
    in fp32 in both packages alike (at log w near -9 each is 6.5e-4 of the
    gradient's max from a float64 evaluation)."""
    rng = np.random.RandomState(2)
    b, c, n, d = 2, 16, 2, 8
    r, k, v = (rng.standard_normal((b, c, n, d)).astype(np.float32)
               for _ in range(3))
    lw = -rng.uniform(5.5, 7, (b, c, n, d)) if strong \
        else -rng.uniform(0.01, 1.0, (b, c, n, d))
    w = np.exp(lw).astype(np.float32)
    u = rng.standard_normal((n, d)).astype(np.float32)
    s0 = rng.standard_normal((b, n, d, d)).astype(np.float32)
    ct_o = rng.standard_normal((b, c, n, d)).astype(np.float32)
    ct_s = rng.standard_normal((b, n, d, d)).astype(np.float32)
    args = (r, k, v, w, u, s0)

    @jax.jit
    def reference(*a):
        out, vjp = jax.vjp(JL._wkv_chunk, *a)
        return out, vjp((ct_o, ct_s))

    (want_o, want_s), want_g = reference(*args)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got_o, got_s = TL._wkv_chunk(*ts)
    torch.autograd.backward([got_o, got_s],
                            [torch.from_numpy(ct_o), torch.from_numpy(ct_s)])
    assert_grads_close([got_o.detach().numpy(), got_s.detach().numpy()],
                       [np.asarray(want_o), np.asarray(want_s)])
    assert_grads_close([t.grad.numpy() for t in ts],
                       [np.asarray(a) for a in want_g])


def test_ssm_scan_under_grad_equals_the_scan_without():
    """The joined chunks (autograd) and the ``out=`` writes (no grad) hold
    the same sums, bit for bit; gradients reach dA, dBx and h0."""
    rng = np.random.RandomState(3)
    dA = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 24, 4, 3))
                          .astype(np.float32))
    dBx = torch.from_numpy(rng.standard_normal((2, 24, 4, 3))
                           .astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 4, 3)).astype(np.float32))
    with torch.no_grad():
        want, want_last = SS._ssm_scan(dA, dBx, h0, chunk=8)
    ins = [t.clone().requires_grad_(True) for t in (dA, dBx, h0)]
    got, got_last = SS._ssm_scan(*ins, chunk=8)
    assert torch.equal(got.detach(), want)
    assert torch.equal(got_last.detach(), want_last)
    (got.sum() + got_last.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in ins)


# ---------------------------------------------------------------------------
# AdamW, the schedule, top-k
# ---------------------------------------------------------------------------

def _opt_tree(dtype, seed=4):
    """A small parameter tree (2-D and stacked leaves, 1-D norm scales, a
    list) and gradients shaped like it: (numpy params, numpy grads)."""
    rng = np.random.RandomState(seed)

    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"w": a(8, 6), "ln": a(6), "slots": [{"w_up": a(3, 6, 5),
                                                   "b": a(5)}]}
    grads = {"w": a(8, 6, scale=0.3), "ln": a(6, scale=0.01),
             "slots": [{"w_up": a(3, 6, 5, scale=2.0), "b": a(5)}]}
    return params, grads, dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,clip", [(0, 1.0), (150, 1.0), (7, 100.0)])
def test_adamw_step_matches_reference(dtype, step, clip):
    """Two AdamW steps from ``step`` (in warmup, in the cosine; clipped or
    not) on the same gradients: new parameters in their dtype (fp32 within
    1e-6 relative, bf16 within one bf16 ulp), fp32 moments within 1e-6
    relative, the int32 step, grad norm and lr."""
    pn, gn, _ = _opt_tree(dtype)
    cfg_kw = dict(lr=1e-2, warmup=100, total_steps=1000, clip_norm=clip)
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: Param(jnp.asarray(a, jdt), ("x",) * a.ndim),
                      pn)
    jg = jax.tree.map(jnp.asarray, gn)
    jopt = jax_init_opt_state(jp)
    jopt["step"] = jnp.asarray(step, jnp.int32)
    tdt = getattr(torch, dtype)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), pn)
    tg = jax.tree.map(torch.from_numpy, gn)
    topt = init_opt_state(tp)
    topt["step"] = torch.tensor(step, dtype=torch.int32)
    jstep = jax.jit(functools.partial(jax_adamw_update,
                                      cfg=JaxOptCfg(**cfg_kw)))
    for _ in range(2):
        jp, jopt, jm = jstep(jp, jg, jopt)
        tp, topt, tm = adamw_update(tp, tg, topt, OptCfg(**cfg_kw))
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == step + 2
    assert int(jopt["step"]) == step + 2
    for key in ("grad_norm", "lr"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    for got, want in zip(leaves(tp), jax.tree.leaves(pvalue(jp))):
        assert got.dtype == tdt
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=ulp,
                                   atol=1e-7)
    for key in ("m", "v"):
        for got, want in zip(leaves(topt[key]), jax.tree.leaves(jopt[key])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-12)


def test_adamw_leaves_its_arguments_alone():
    pn, gn, _ = _opt_tree("float32")
    tp = jax.tree.map(torch.from_numpy, pn)
    before = [t.clone() for t in leaves(tp)]
    opt = init_opt_state(tp)
    new_p, new_opt, _ = adamw_update(tp, jax.tree.map(torch.from_numpy, gn),
                                     opt, OptCfg(lr=1e-2))
    assert all(torch.equal(a, b) for a, b in zip(leaves(tp), before))
    assert all(float(m.abs().max()) == 0.0 for m in leaves(opt["m"]))
    assert int(opt["step"]) == 0 and int(new_opt["step"]) == 1
    assert not any(torch.equal(a, b) for a, b in zip(leaves(new_p), before)
                   if a.dim() > 1)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 550, 999, 1000,
                                  5000])
def test_schedule_matches_reference(step):
    """Warmup, the switch to the cosine, mid-way, the end and past it."""
    cfg = dict(lr=3e-4, warmup=100, total_steps=1000)
    want = float(jax_schedule(JaxOptCfg(**cfg), jnp.asarray(step, jnp.int32)))
    got = schedule(OptCfg(**cfg), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_topk_keeps_every_tie_at_the_threshold():
    """k = 3 of 10, but |g| = 2 ties at the threshold: five survive in both
    packages; a 0-d leaf and ratio >= 1 pass through; compressed +
    residual = corrected."""
    g = np.array([3.0, -3.0, 2.0, -2.0, 2.0, 1.0, 0.5, -0.1, 0.0, 1.5],
                 np.float32)
    tree = {"g": g, "s": np.float32(4.0)}
    want, want_ef = jax_topk(jax.tree.map(jnp.asarray, tree), None, ratio=0.3)
    got, got_ef = topk_compress_decompress(
        {k: torch.tensor(v) for k, v in tree.items()}, None, ratio=0.3)
    assert int((got["g"] != 0).sum()) == 5
    for key in tree:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(got_ef[key].numpy(),
                                      np.asarray(want_ef[key]))
    assert float(got["s"]) == 4.0
    same, none_left = topk_compress_decompress({"g": torch.tensor(g)}, None,
                                               ratio=1.0)
    assert torch.equal(same["g"], torch.tensor(g))
    assert float(none_left["g"].abs().sum()) == 0.0


def test_topk_error_feedback_matches_reference():
    """Two rounds on random gradients, the residual carried: equal to the
    reference's, and the second round drains the residual (mirrors
    ``tests/test_train_integration.py``)."""
    rng = np.random.RandomState(5)
    g = {"w": rng.standard_normal((64, 64)).astype(np.float32),
         "b": rng.standard_normal(64).astype(np.float32)}
    jg, tg = jax.tree.map(jnp.asarray, g), jax.tree.map(torch.from_numpy, g)
    js, jef = jax_topk(jg, None, ratio=0.1)
    ts, tef = topk_compress_decompress(tg, None, ratio=0.1)
    assert 0.05 < float((ts["w"] != 0).float().mean()) < 0.15
    zeros = {k: torch.zeros_like(v) for k, v in tg.items()}
    js2, jef2 = jax_topk(jax.tree.map(jnp.zeros_like, jg), jef, ratio=0.1)
    ts2, tef2 = topk_compress_decompress(zeros, tef, ratio=0.1)
    for got, want in ((ts, js), (tef, jef), (ts2, js2), (tef2, jef2)):
        for key in g:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    assert float(tef2["w"].abs().sum()) < float(tef["w"].abs().sum())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

SPEC_KW = dict(name="m100k", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab=256)
# eps 1e-3: Adam's first update g / (|g| + eps) moves by at most 1/eps
# times a gradient's last digits, so that parameters compare within 1e-6
STEP_OPT = dict(lr=1e-2, warmup=2, eps=1e-3)


def _pipeline(B=8, S=32, cls=TokenPipeline, cfg=DataCfg):
    return cls(cfg(global_batch=B, seq_len=S, vocab=SPEC_KW["vocab"], seed=7))


@pytest.mark.parametrize("grad_accum,ratio", [(1, 0.0), (4, 0.0), (1, 0.1)])
def test_train_step_matches_reference(grad_accum, ratio):
    """Two steps of ``make_train_step`` on pipeline batches 0 and 1
    (B 8, S 32; fp32, chunked attention in chunks of 16) against the
    reference's jitted step: the loss within 1e-5 relative, grad norm
    within 1e-4, parameters within 1e-6 + 1e-5 relative, moments within
    1e-4 * max + 1e-9, the error-feedback buffer within 1e-4 * max +
    1e-7."""
    jspec, tspec = JaxModelSpec(**SPEC_KW), ModelSpec(**SPEC_KW)
    jrt, trt = runtimes(impl="chunked")
    jrt = dataclasses.replace(jrt, attn_chunk=16)
    trt = dataclasses.replace(trt, attn_chunk=16)
    jparams, tparams = shared_params(jspec)
    jopt, topt = jax_init_opt_state(jparams), init_opt_state(tparams)
    kw = dict(grad_accum=grad_accum, compress_ratio=ratio)
    jstep = jax.jit(jax_make_train_step(jspec, jrt, JaxOptCfg(**STEP_OPT),
                                        **kw))
    tstep = make_train_step(tspec, trt, OptCfg(**STEP_OPT), **kw)
    pipe = _pipeline()
    for i in range(2):
        batch = pipe.batch(i)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v)
                                                  for k, v in batch.items()})
        tparams, topt, tm = tstep(tparams, topt, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for got, want in zip(leaves(tparams), jax.tree.leaves(pvalue(jparams))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    keys = ("m", "v", "ef") if ratio else ("m", "v")
    assert sorted(topt) == sorted(jopt) == sorted(keys + ("step",))
    for key in keys:
        assert_grads_close([t.numpy() for t in leaves(topt[key])],
                           [np.asarray(a) for a in jax.tree.leaves(jopt[key])],
                           floor=1e-9 if key != "ef" else 1e-7)


def test_grad_accumulation_consistency():
    """Mirror of the reference's test: one step over the whole batch and
    one over four micro-batches give the loss within 2e-2 and parameters
    within 5e-2 (default OptCfg); the accumulated gradients are fp32."""
    spec = ModelSpec(**SPEC_KW)
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32",
                    attention_impl="chunked", attn_chunk=16)
    params = init_params(spec, rt, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _pipeline().batch(0).items()}
    p1, _, m1 = make_train_step(spec, rt, OptCfg())(
        params, init_opt_state(params), batch)
    p4, _, m4 = make_train_step(spec, rt, OptCfg(), grad_accum=4)(
        params, init_opt_state(params), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p1), leaves(p4))) < 5e-2


def test_train_step_leaves_the_callers_state_alone():
    """The reference pops ``ef`` from the state it is given; the port copies
    first, so the caller's dict keeps it.  Without compression ``ef`` rides
    along unchanged."""
    spec = ModelSpec(**SPEC_KW)
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32",
                    attention_impl="chunked", attn_chunk=16)
    params = init_params(spec, rt, device="cpu")
    opt = init_opt_state(params)
    opt["ef"] = {"marker": torch.ones(3)}
    before = dict(opt)
    batch = {k: torch.from_numpy(v) for k, v in _pipeline().batch(0).items()}
    _, new_opt, _ = make_train_step(spec, rt, OptCfg())(params, opt, batch)
    assert opt == before and opt["ef"] is before["ef"]
    assert new_opt["ef"] is before["ef"]
    assert int(opt["step"]) == 0 and int(new_opt["step"]) == 1


def test_loss_decreases():
    """Mirror of ``tests/test_train_integration.py::test_loss_decreases``:
    twelve steps on one pipeline batch, lr 1e-2, warmup 2, bf16 params and
    chunked attention: the last loss at least 0.3 below the first."""
    spec = ModelSpec(**SPEC_KW)
    rt = RuntimeCfg(attention_impl="chunked", attn_chunk=16)
    params = init_params(spec, rt, device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(spec, rt, OptCfg(lr=1e-2, warmup=2))
    fixed = {k: torch.from_numpy(v) for k, v in _pipeline().batch(0).items()}
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, fixed)
        losses.append(float(m["loss"]))
    assert all(t.dtype == torch.bfloat16 for t in leaves(params)
               if t.dim() > 1 and t.dtype != torch.float32)
    assert losses[-1] < losses[0] - 0.3, losses
    assert int(opt["step"]) == 12


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2])
def test_token_pipeline_bytes_equal_reference(hosts):
    for host in range(hosts):
        kw = dict(global_batch=8, seq_len=16, vocab=100, seed=3,
                  num_hosts=hosts, host_id=host)
        mine, theirs = TokenPipeline(DataCfg(**kw)), \
            JaxTokenPipeline(JaxDataCfg(**kw))
        for step in (0, 1, 5, 1234):
            a, b = mine.batch(step), theirs.batch(step)
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for key in a:
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()


def test_token_pipeline_corpus_bytes_equal_reference(tmp_path):
    path = tmp_path / "corpus.u16"
    np.random.RandomState(6).randint(0, 60000, size=5000) \
        .astype(np.uint16).tofile(path)
    kw = dict(global_batch=4, seq_len=32, vocab=1000, seed=1,
              corpus=str(path))
    a = TokenPipeline(DataCfg(**kw)).batch(3)
    b = JaxTokenPipeline(JaxDataCfg(**kw)).batch(3)
    for key in b:
        assert a[key].tobytes() == b[key].tobytes()


# ---------------------------------------------------------------------------
# gradient rules at ties
# ---------------------------------------------------------------------------

TIE = np.array([1.0, 2.0, 2.0, 0.0], np.float32)
# (id, the port's function, the reference's): each at inputs that tie
TIE_RULES = [
    ("maximum-floor", lambda x: torch.maximum(x, x.new_tensor(2.0)),
     lambda x: jnp.maximum(x, 2.0)),
    ("maximum-pair", lambda x: torch.maximum(x[1:3], x[2:]),
     lambda x: jnp.maximum(x[1:3], x[2:])),
    ("amax", lambda x: x.amax(-1, keepdim=True), lambda x: x.max(-1,
                                                             keepdims=True)),
    ("relu-at-zero", torch.relu, jax.nn.relu),
    ("where", lambda x: torch.where(x >= 2.0, x, torch.zeros_like(x)),
     lambda x: jnp.where(x >= 2.0, x, 0.0)),
    ("logaddexp-softplus-at-zero",
     lambda x: torch.logaddexp(x, x.new_zeros(())),
     lambda x: jnp.logaddexp(x, 0.0)),
    ("top-k-cut-inside-a-tie",
     lambda x: TL.top_k_lowest_first(x, 2)[0] * x.new_tensor([1.0, 3.0]),
     lambda x: jax.lax.top_k(x, 2)[0] * jnp.array([1.0, 3.0])),
]


@pytest.mark.parametrize("rule", TIE_RULES, ids=[r[0] for r in TIE_RULES])
def test_gradient_rules_at_ties_match(rule):
    """The primitives the port's differentiated paths use split (or route)
    the gradient at a tie as JAX does: maximum and max give each tied input
    half, relu gives 0 at 0, logaddexp 1/2 at equal arguments, the stable
    top-k picks the lower index.  Within 1e-6 relative (logaddexp's
    gradient away from the tie differs in its last bit); a different rule
    at a tie differs by a half or more."""
    _, mine, theirs = rule
    x = torch.tensor(TIE, requires_grad=True)
    mine(x).sum().backward()
    want = jax.grad(lambda a: theirs(a).sum())(jnp.asarray(TIE))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_clamp_differs_from_maximum_at_a_tie():
    """``torch.clamp(x, min=c)`` passes the whole gradient at x == c, where
    ``jnp.maximum(x, c)`` passes half: the port uses ``torch.maximum``
    where the reference has ``jnp.maximum`` on a differentiated path (the
    MoE gate normalisation, the attention and WKV floors)."""
    x = torch.tensor(TIE, requires_grad=True)
    torch.clamp(x, min=2.0).sum().backward()
    want = jax.grad(lambda a: jnp.maximum(a, 2.0).sum())(jnp.asarray(TIE))
    assert x.grad.tolist() == [0.0, 1.0, 1.0, 0.0]
    assert np.asarray(want).tolist() == [0.0, 0.5, 0.5, 0.0]


# ---------------------------------------------------------------------------
# the kernels refuse to be differentiated
# ---------------------------------------------------------------------------

def _kernel_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 2, 16, generator=g)
    k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(2))
    r, kk, vv = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    w = torch.rand(1, 8, 2, 16, generator=g)
    u, s0 = torch.randn(2, 16, generator=g), torch.zeros(1, 2, 16, 16)
    x, cw = torch.randn(3, 10, generator=g), torch.randn(4, 10, generator=g)
    dtt = torch.rand(2, 8, 6, generator=g)
    xc, a_log = torch.randn(2, 8, 6, generator=g), torch.randn(6, 4, generator=g)
    bc = torch.randn(2, 8, 8, generator=g)
    h0 = torch.randn(2, 6, 4, generator=g)
    scan = (dtt, xc, bc[..., :4], bc[..., 4:], a_log, h0)
    return {
        "flash_attention": (lambda *a: ops.flash_attention(*a), (q, k, v),
                            lambda *a: flash_attention_plain(*a)),
        "wkv6": (lambda *a: ops.wkv6(*a, chunk=4)[0],
                 (r, kk, vv, w, u, s0),
                 lambda *a: wkv6_plain(*a, chunk=4)[0]),
        "cost_reduce": (ops.cost_reduce, (x, cw), cost_reduce_plain),
        "selective_scan": (lambda *a: ops.selective_scan(*a)[0], scan,
                           lambda *a: SS.selective_scan_plain(*a)[0]),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv6",
                                    "cost_reduce", "selective_scan"])
def test_kernel_entries_refuse_grad(kernel):
    """Under grad mode any floating input that requires grad raises,
    naming the kernel (on the CPU as on the card); without one, or under
    ``no_grad``, the entry runs; the plain version stays differentiable."""
    entry, args, plain = _kernel_inputs()[kernel]
    entry(*args)                                      # nothing requires grad
    for i in range(len(args)):
        grad_args = [a.clone().requires_grad_(j == i)
                     for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match=kernel):
            entry(*grad_args)
        with torch.no_grad():
            entry(*grad_args)
    leaf = args[0].clone().requires_grad_(True)
    plain(leaf, *args[1:]).sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


@pytest.mark.parametrize("name,kernel", [("qwen3-14b", "flash_attention"),
                                         ("rwkv6-7b", "wkv6"),
                                         ("jamba-v0.1-52b", "selective_scan")])
def test_train_step_through_the_kernels_raises(name, kernel):
    """``attention_impl="cuda"`` routes attention, WKV and the Mamba scan
    through the forward-only kernels: the first step raises, no fallback
    (jamba's first layer is a Mamba mixer)."""
    spec = get(name).smoke
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32")
    params = init_params(spec, rt, device="cpu")
    step = make_train_step(spec, rt, OptCfg())
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(DataCfg(
        global_batch=2, seq_len=8, vocab=spec.vocab)).batch(0).items()}
    with pytest.raises(RuntimeError, match=kernel):
        step(params, init_opt_state(params), batch)


def test_prefill_records_no_graph():
    """Serving's prefill runs under ``no_grad`` now that ``forward`` does
    not: parameters that require grad give logits without a graph, through
    the kernel's entry, which would refuse otherwise."""
    spec = get("qwen3-14b").smoke
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32")
    params = lm._tree_map(lambda t: t.requires_grad_(True),
                          init_params(spec, rt, device="cpu"))
    tokens = torch.zeros((1, 5), dtype=torch.long)
    out = make_prefill(spec, rt)(params, tokens)
    assert out.shape == (1, 1, spec.vocab) and not out.requires_grad
    assert lm.forward(params, tokens, spec, dataclasses.replace(
        rt, attention_impl="naive")).requires_grad
