"""The port's Mamba mixer against the JAX package's on the CPU: the chunked
selective scan ``_ssm_scan`` and ``mamba_layer`` (prefill and cache steps).

Inputs come from numpy with a seed; the layer's weights are drawn by the JAX
package's ``init_mamba`` and carried across.  fp32 throughout: the scan
within 1e-6 relative (the port combines the same pairs in the same order as
``jax.lax.associative_scan``), the layer within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import layers as JL
from repro.models.common import Initializer as JaxInitializer
from repro.models.common import pvalue
from repro_torch.models import layers as L
from repro_torch.models import params_from_reference
from torch_port_helpers import as_f32, port_spec, runtimes, to_jax, to_torch

JSPEC = jax_get("jamba-v0.1-52b").smoke
TSPEC = port_spec(JSPEC)
DIN = JSPEC.ssm.expand * JSPEC.d_model
P = JSPEC.ssm.d_state


def _scan_inputs(seed, b, s, d, p):
    rng = np.random.RandomState(seed)
    dA = np.exp(-rng.uniform(0.0, 2.0, size=(b, s, d, p)))     # (0, 1]
    dBx = rng.standard_normal((b, s, d, p))
    h0 = rng.standard_normal((b, d, p))
    return dA, dBx, h0


@pytest.mark.parametrize("s", [40, 512, 300],
                         ids=["below-chunk", "two-chunks", "not-a-multiple"])
def test_ssm_scan(s):
    """The layer's chunk rule, ``min(s, 256)``: one chunk of 40; two chunks
    of 256 carried over; 300 is no multiple of 256, so one chunk of 300."""
    dA, dBx, h0 = _scan_inputs(s, 2, s, 6, 4)
    chunk = min(s, 256)
    want_hs, want_h = JL._ssm_scan(to_jax(dA), to_jax(dBx), to_jax(h0), chunk)
    got_hs, got_h = L._ssm_scan(to_torch(dA), to_torch(dBx), to_torch(h0),
                                chunk)
    assert got_hs.shape == (2, s, 6, 4) and got_h.shape == (2, 6, 4)
    for got, want in ((got_hs, want_hs), (got_h, want_h)):
        want = as_f32(want)
        np.testing.assert_allclose(as_f32(got), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_ssm_scan_is_the_recurrence():
    """Both scans against the recurrence h_t = dA_t h_{t-1} + dBx_t run step
    by step in float64."""
    dA, dBx, h0 = _scan_inputs(7, 1, 300, 3, 2)
    h, ref = h0, []
    for t in range(300):
        h = dA[:, t] * h + dBx[:, t]
        ref.append(h)
    ref = np.stack(ref, axis=1)
    got, _ = L._ssm_scan(to_torch(dA), to_torch(dBx), to_torch(h0), 256)
    np.testing.assert_allclose(as_f32(got), ref, rtol=1e-5, atol=1e-5)


def _layer_params(seed=0):
    ini = JaxInitializer(jax.random.PRNGKey(seed), "float32")
    jp = JL.init_mamba(ini, JSPEC, "m_")
    return jp, params_from_reference(jax.tree.map(np.asarray, pvalue(jp)),
                                     device="cpu")


def test_init_mamba_tree():
    """Same leaves and shapes as the reference's; ``A_log`` fp32 at bf16."""
    ini = JaxInitializer(jax.random.PRNGKey(0), "bfloat16")
    want = {k: (tuple(v.value.shape), str(v.value.dtype))
            for k, v in JL.init_mamba(ini, JSPEC, "m_").items()}
    from repro_torch.models.common import Initializer
    mine = L.init_mamba(Initializer(torch.Generator().manual_seed(0),
                                    "bfloat16", "cpu"), TSPEC, "m_")
    got = {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in mine.items()}
    assert got == want and got["A_log"][1] == "float32"


@pytest.mark.parametrize("s", [20, 300])
def test_mamba_layer_prefill(s):
    jp, tp = _layer_params()
    jrt, trt = runtimes()
    x = np.random.RandomState(s).standard_normal((2, s, JSPEC.d_model))
    want, wc = JL.mamba_layer(jp, to_jax(x), JSPEC, jrt, None)
    got, tc = L.mamba_layer(tp, to_torch(x), TSPEC, trt)
    assert wc is None and tc is None
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-5,
                               atol=1e-5)


def test_mamba_layer_cache_steps():
    """From a random conv window and state: three one-token steps, then a
    two-token step; the port's cache tensors are written in place and equal
    the reference's new cache."""
    jp, tp = _layer_params(1)
    jrt, trt = runtimes()
    rng = np.random.RandomState(3)
    conv = rng.standard_normal((2, 3, DIN))
    ssm = rng.standard_normal((2, DIN, P))
    jcache = {"conv": to_jax(conv), "ssm": to_jax(ssm)}
    tcache = {"conv": to_torch(conv), "ssm": to_torch(ssm)}
    conv_t, ssm_t = tcache["conv"], tcache["ssm"]
    for s in (1, 1, 1, 2):
        x = rng.standard_normal((2, s, JSPEC.d_model))
        want, jcache = JL.mamba_layer(jp, to_jax(x), JSPEC, jrt, None,
                                      cache=jcache)
        got, tcache = L.mamba_layer(tp, to_torch(x), TSPEC, trt, cache=tcache)
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-5,
                                   atol=1e-5)
        assert tcache["conv"] is conv_t and tcache["ssm"] is ssm_t
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(as_f32(tcache[k]), as_f32(jcache[k]),
                                       rtol=1e-5, atol=1e-5)


def test_prefill_then_steps_is_one_prefill():
    """A prefill of 6 tokens split as 4 + 1 + 1 through the cache gives the
    one prefill's outputs (the conv window and the state carry exactly)."""
    _, tp = _layer_params(2)
    _, trt = runtimes()
    x = to_torch(np.random.RandomState(4).standard_normal(
        (2, 6, JSPEC.d_model)))
    whole, _ = L.mamba_layer(tp, x, TSPEC, trt)
    cache = {"conv": torch.zeros((2, 3, DIN)),
             "ssm": torch.zeros((2, DIN, P))}
    parts = []
    for a, b in ((0, 4), (4, 5), (5, 6)):
        y, cache = L.mamba_layer(tp, x[:, a:b], TSPEC, trt, cache=cache)
        parts.append(y)
    np.testing.assert_allclose(as_f32(torch.cat(parts, 1)), as_f32(whole),
                               rtol=1e-5, atol=1e-5)


def test_softplus_is_jax_softplus():
    """No threshold: above 20 too it is log(1 + e^x), as jax.nn.softplus."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(as_f32(L._softplus(to_torch(x))),
                               as_f32(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)
