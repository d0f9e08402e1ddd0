"""The port's MoE FFN against the JAX package's ``moe_ffn`` (single-device
path) on the CPU: weights initialised by the JAX package and carried across,
activations from numpy with a seed.

Tolerances: fp32 outputs 1e-4 (the same arithmetic in another order of
sums); bf16 outputs two bf16 ulps at the largest output, 2^-6 max|out|
absolute (0.25 at outputs up to 16: both sides round h, the expert
products, the gate-weighted outputs, each add of the combine and the
residual add to bf16, at other places inside a product, so an output that
cancels to near 0 keeps an error of the size of its terms' ulps).  Routing is compared exactly: the dispatched tensor ``[E, C, H]`` of
both packages holds the same token rows in the same (expert, rank) slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.core import ModelSpec as JaxModelSpec
from repro.core import MoESpec as JaxMoESpec
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.common import pvalue
from repro_torch.configs import get
from repro_torch.models import RuntimeCfg, init_params, lm, \
    params_from_reference
from repro_torch.models import layers as TL
from torch_port_helpers import as_f32, port_spec, runtimes, shared_params

ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
# (batch, seq): a prefill and the decode steps of an 8- and a 2-slot engine
SHAPES = [(2, 16), (8, 1), (2, 1)]


class _Recorder:
    """Stands in for ``jnp`` inside ``repro.models.layers`` and keeps the
    first operand of every expert product ``ech,ehf->ecf``: the reference's
    dispatched tensor, which its ``moe_ffn`` does not return."""

    def __init__(self):
        self.dispatched = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, subscripts, *operands, **kw):
        if subscripts == "ech,ehf->ecf":
            self.dispatched.append(np.asarray(operands[0], np.float32))
        return jnp.einsum(subscripts, *operands, **kw)


def _moe_layer(name, dtype):
    """(JAX spec, port spec, JAX layer params, port layer params): the MoE
    FFN of the first stacked layer of the smoke spec."""
    jspec = jax_get(name).smoke
    jparams, tparams = shared_params(jspec, dtype)
    jl = JLM._index(jparams["slots"][0], 0)["moe"]
    tl = lm._index(tparams["slots"][0], 0)["moe"]
    return jspec, port_spec(jspec), jl, tl


def _x(shape, h, seed, dtype):
    x = np.random.RandomState(seed).standard_normal(shape + (h,)) \
        .astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _run_both(monkeypatch, name, dtype, shape, cf):
    jspec, tspec, jl, tl = _moe_layer(name, dtype)
    jrt, trt = runtimes(dtype)
    jx, tx = _x(shape, tspec.d_model, sum(shape) + int(cf * 100), dtype)
    rec = _Recorder()
    monkeypatch.setattr(JL, "jnp", rec)
    want = JL.moe_ffn(jl, jx, jspec, jrt, None, capacity_factor=cf)
    monkeypatch.undo()
    got = TL.moe_ffn(tl, tx, tspec, trt, capacity_factor=cf)
    h = TL.rms_norm(tl["ln"], tx)
    route = TL.moe_dispatch(h, tl["w_router"], E=tspec.moe.n_experts,
                            Kk=tspec.moe.top_k, capacity_factor=cf)
    return want, got, rec.dispatched[0], route


def _kept_pairs(dispatched) -> set:
    d = as_f32(dispatched)
    e, c = np.nonzero(np.abs(d).sum(-1) > 0)
    return set(zip(e.tolist(), c.tolist()))


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("shape", SHAPES, ids=["prefill", "decode8", "decode2"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_fp32(monkeypatch, name, shape, cf):
    """Outputs within 1e-4, and the same (expert, rank) slots holding the
    same token rows: the stable sort keeps each expert's choices in token
    order, so both packages drop the same choices past capacity."""
    want, got, jdisp, route = _run_both(monkeypatch, name, "float32", shape,
                                        cf)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-4,
                               rtol=1e-4)
    mine = route["dispatched"]
    assert mine.shape == jdisp.shape
    assert _kept_pairs(mine) == _kept_pairs(jdisp)
    np.testing.assert_allclose(as_f32(mine), jdisp, atol=1e-5, rtol=1e-5)
    # the capacity C = ceil(T K / E cf) is the reference's
    T = shape[0] * shape[1]
    spec = get(name).smoke
    assert route["C"] == max(1, int(np.ceil(T * spec.moe.top_k
                                            / spec.moe.n_experts * cf)))


def test_capacity_drops_choices_at_decode(monkeypatch):
    """An 8-slot decode step at half capacity drops choices (C = 1 per
    expert), and the kept ones are the first of each expert's run in token
    order."""
    _, _, jdisp, route = _run_both(monkeypatch, "deepseek-moe-16b", "float32",
                                   (8, 1), 0.5)
    keep = route["keep"]
    assert route["C"] == 1 and (~keep).any() and keep.any()
    se, st = route["se"], route["st"]
    for e in se[keep].tolist():
        run = st[se == e]
        assert run.tolist() == sorted(run.tolist())      # token order
        assert st[keep & (se == e)].tolist() == run[:1].tolist()
    assert _kept_pairs(route["dispatched"]) == _kept_pairs(jdisp)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["prefill", "decode8"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_bf16(monkeypatch, name, shape):
    """bf16 parameters and activations, fp32 router: the same slots, the
    outputs within two bf16 ulps at the largest output (module
    docstring)."""
    want, got, jdisp, route = _run_both(monkeypatch, name, "bfloat16", shape,
                                        1.25)
    assert got.dtype == torch.bfloat16
    w = as_f32(want)
    np.testing.assert_allclose(as_f32(got), w,
                               atol=2.0 ** -6 * np.abs(w).max(), rtol=0)
    assert _kept_pairs(route["dispatched"]) == _kept_pairs(jdisp)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_shared_experts(monkeypatch, n_shared):
    """With and without shared experts: the shared FFN runs straight on the
    normalised h (no norm of its own), added to the routed output."""
    kw = dict(name="moe-t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
              d_ff=96, vocab=64, d_head=16)
    jspec = JaxModelSpec(**kw, moe=JaxMoESpec(n_experts=4, top_k=2,
                                              n_shared=n_shared, d_expert=32))
    tspec = port_spec(jspec)
    jparams, tparams = shared_params(jspec)
    jl = JLM._index(jparams["slots"][0], 0)["moe"]
    tl = lm._index(tparams["slots"][0], 0)["moe"]
    assert ("shared" in tl) == bool(n_shared)
    jrt, trt = runtimes()
    jx, tx = _x((2, 6), 64, 7, "float32")
    want = JL.moe_ffn(jl, jx, jspec, jrt, None)
    got = TL.moe_ffn(tl, tx, tspec, trt)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-4,
                               rtol=1e-4)


def test_top_k_tie_order_is_the_reference_s():
    """Equal probabilities: the lower expert index first, as jax.lax.top_k."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = TL.top_k_lowest_first(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("name", ARCHS)
def test_router_stays_fp32(name):
    """The port's init draws w_router in fp32 at a bf16 parameter dtype, as
    the reference; a bf16 conversion of the reference's fp32 tree keeps the
    router fp32 and casts everything else."""
    spec = get(name).smoke
    mine = init_params(spec, RuntimeCfg(), device="cpu")
    moe = mine["slots"][0]["moe"]
    assert moe["w_router"].dtype == torch.float32
    assert moe["w_egate"].dtype == torch.bfloat16
    jparams, _ = shared_params(jax_get(name).smoke, "float32")
    tree = jax.tree.map(np.asarray, pvalue(jparams))
    cast = params_from_reference(tree, device="cpu", dtype="bfloat16")
    assert cast["slots"][0]["moe"]["w_router"].dtype == torch.float32
    assert cast["slots"][0]["moe"]["w_eup"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16


def test_bf16_conversion_routes_as_the_reference(monkeypatch):
    """dsmoe-smoke initialised by the reference in bf16 (router fp32) and
    converted with dtype='bfloat16': the port dispatches the same token rows
    to the same slots as the reference's moe_ffn."""
    jspec = jax_get("deepseek-moe-16b").smoke
    tspec = port_spec(jspec)
    jparams, _ = shared_params(jspec, "bfloat16")
    tree = jax.tree.map(np.asarray, pvalue(jparams))
    tparams = params_from_reference(tree, device="cpu", dtype="bfloat16")
    jl = JLM._index(jparams["slots"][0], 0)["moe"]
    tl = lm._index(tparams["slots"][0], 0)["moe"]
    assert tl["w_router"].dtype == torch.float32
    jrt, trt = runtimes("bfloat16")
    jx, tx = _x((2, 16), tspec.d_model, 11, "bfloat16")
    rec = _Recorder()
    monkeypatch.setattr(JL, "jnp", rec)
    JL.moe_ffn(jl, jx, jspec, jrt, None)
    monkeypatch.undo()
    h = TL.rms_norm(tl["ln"], tx)
    route = TL.moe_dispatch(h, tl["w_router"], E=tspec.moe.n_experts,
                            Kk=tspec.moe.top_k, capacity_factor=1.25)
    assert _kept_pairs(route["dispatched"]) == _kept_pairs(rec.dispatched[0])
    # the same token in each slot: rows equal up to one bf16 ulp (each side
    # rounds its own fp32 rms_norm to bf16)
    np.testing.assert_allclose(as_f32(route["dispatched"]),
                               rec.dispatched[0], rtol=2.0 ** -7, atol=0)
