"""Shared helpers of the tests that hold ``repro_torch`` against ``repro``:
inputs come from numpy with a seed and go to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import RuntimeCfg as JaxRuntimeCfg
from repro.models import init_params as jax_init_params
from repro.models.common import pvalue
from repro_torch.models import RuntimeCfg, params_from_reference


def to_jax(a: np.ndarray, dtype="float32"):
    return jnp.asarray(a, dtype=jnp.dtype(dtype))


def to_torch(a: np.ndarray, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def as_f32(x) -> np.ndarray:
    """A jax array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def runtimes(dtype="float32", impl="naive", jax_impl=None):
    """The same runtime config for both packages."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (JaxRuntimeCfg(attention_impl=jax_impl or impl, **kw),
            RuntimeCfg(attention_impl=impl, **kw))


def shared_params(spec, dtype="float32", seed=0):
    """Parameters initialised by the JAX package and carried across:
    (jax Param tree, torch tree on the CPU)."""
    jrt, _ = runtimes(dtype)
    jparams = jax_init_params(spec, jrt, jax.random.PRNGKey(seed))
    as_numpy = jax.tree.map(np.asarray, pvalue(jparams))
    return jparams, params_from_reference(as_numpy, device="cpu")
