"""The port's sharding specs against the JAX package's, in process (no
process group): the logical rules, every parameter's spec, the ZeRO-1
moments' specs, the activation specs and the decode caches' specs, for all
ten architectures at published size on the meshes (2, 4), (16, 16) and
(2, 16, 16).  The reference runs on a ``jax.sharding.AbstractMesh`` (no
devices), the port on a plain mapping of axis name to size; both give
``PartitionSpec``s, the port's as tuples, compared exactly.  The port's
parameter shapes come from ``init_params`` on the meta device (nothing
drawn), the reference's from ``eval_shape``."""
import functools
import itertools
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get as jax_get
from repro.models import RuntimeCfg as JaxRuntimeCfg
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.common import AxisRules as JaxAxisRules
from repro.models.common import Param
from repro.parallel.sharding import cache_shardings as jax_cache_shardings
from repro.parallel.sharding import logical_rules as jax_logical_rules
from repro.parallel.sharding import param_pspec as jax_param_pspec
from repro.parallel.sharding import param_shardings as jax_param_shardings
from repro.train.optimizer import \
    opt_state_shardings as jax_opt_state_shardings
from repro_torch.configs import get
from repro_torch.core import ModelSpec
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import AxisRules, RuntimeCfg, init_cache, init_params
from repro_torch.models import layers as L
from repro_torch.models import param_axes
from repro_torch.parallel import (cache_shardings, logical_rules,
                                  param_shardings, spec_placements)
from repro_torch.train import opt_state_shardings

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["2x4", "16x16", "2x16x16"]


def _meshes(shape, names):
    """(the reference's abstract mesh, the port's mapping, data axes)."""
    return (AbstractMesh(shape, names), dict(zip(names, shape)),
            tuple(a for a in names if a in ("pod", "data")))


def _flat(tree, path=""):
    """{path: leaf} of a tree of dicts and lists (tuples are leaves)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat(x, f"{path}/{i}").items()}
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _reference_params(name):
    return jax.eval_shape(
        functools.partial(jax_init_params, jax_get(name).spec,
                          JaxRuntimeCfg()), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(name):
    spec = get(name).spec
    return (init_params(spec, RuntimeCfg(), torch.Generator(device="cpu"),
                        device="meta"), param_axes(spec))


def _jax_flat(tree):
    """{path: leaf} of the reference's trees (``Param`` and sharding
    leaves), with the port's path convention."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, Param))[0]:
        path = "".join(f"/{getattr(k, 'key', getattr(k, 'idx', None))}"
                       for k in kp)
        out[path] = leaf
    return out


# ---- rules ------------------------------------------------------------------

RULE_GRID = list(itertools.product(
    (True, False), (True, False), (True, False),
    (("pod", "data"), ("data",)), (None, {"act_kv": "model", "lora": "data"})))


@pytest.mark.parametrize("sp,fsdp,kv,data_axes,extra", RULE_GRID)
def test_logical_rules_equal_reference(sp, fsdp, kv, data_axes, extra):
    kw = dict(sp=sp, fsdp=fsdp, shard_kv_heads=kv, data_axes=data_axes,
              extra=extra)
    assert logical_rules(**kw) == jax_logical_rules(**kw)


# every tuple of logical axes the layers and lm constrain an activation to
ACTIVATIONS = [(L.BATCH, L.SEQ, L.EMB), (L.BATCH, L.SEQ, L.KV, L.QGRP, L.HDIM),
               (L.BATCH, L.SEQ, L.FFN), (L.BATCH, L.SEQ, L.VOCAB)]


@pytest.mark.parametrize("sp,fsdp,kv,data_axes,extra", RULE_GRID)
def test_activation_specs_equal_reference(sp, fsdp, kv, data_axes, extra):
    """``AxisRules.spec`` keeps the reference's used-axis rule: with
    sequence parallelism q's sequence takes ``model`` and its kv heads get
    nothing (an empty entry, not trimmed)."""
    rules = logical_rules(sp=sp, fsdp=fsdp, shard_kv_heads=kv,
                          data_axes=data_axes, extra=extra)
    for axes in ACTIVATIONS:
        assert AxisRules(rules).spec(axes) == \
            tuple(JaxAxisRules(rules).spec(axes)), axes


def test_sequence_parallel_q_spec():
    rules = logical_rules(sp=True, data_axes=("data",))
    q_axes = (L.BATCH, L.SEQ, L.KV, L.QGRP, L.HDIM)
    assert AxisRules(rules).spec(q_axes) == ("data", "model", None)
    no_sp = logical_rules(sp=False, data_axes=("data",))
    assert AxisRules(no_sp).spec(q_axes) == ("data", None, "model")
    assert AxisRules(rules).spec((L.BATCH, L.SEQ, L.VOCAB)) == \
        ("data", "model", None)


# ---- parameters and the ZeRO-1 moments ---------------------------------------

@pytest.mark.parametrize("mesh_shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_moment_specs_equal_reference(name, mesh_shape, names):
    """Every leaf's spec at published size, FSDP on and off, and the
    moments' with ZeRO-1 on and off."""
    jmesh, mesh, data_axes = _meshes(mesh_shape, names)
    jparams = _reference_params(name)
    params, axes = _port_params(name)
    for fsdp in (False, True):
        rules = logical_rules(fsdp=fsdp, data_axes=data_axes)
        want = {p: tuple(s.spec) for p, s in
                _jax_flat(jax_param_shardings(jparams, rules, jmesh)).items()}
        got = {p: s.spec for p, s in
               _flat(param_shardings(params, axes, rules, mesh)).items()}
        assert got == want, (name, fsdp)
        for zero1 in (True, False):
            jo = jax_opt_state_shardings(jparams, rules, jmesh, zero1=zero1,
                                         data_axes=data_axes)
            o = opt_state_shardings(params, axes, rules, mesh, zero1=zero1,
                                    data_axes=data_axes)
            want_m = {p: tuple(s.spec) for p, s in _jax_flat(jo["m"]).items()}
            assert {p: s.spec for p, s in _flat(o["m"]).items()} == want_m
            assert o["v"] == o["m"]
            assert o["step"].spec == tuple(jo["step"].spec) == ()


def test_param_pspec_one_leaf_equal_reference():
    """A dimension that does not divide is left unsharded and its mesh axes
    stay free for a later dimension (the ``used`` set)."""
    from repro_torch.parallel import param_pspec
    jmesh, mesh, _ = _meshes((2, 4), ("data", "model"))
    rules = logical_rules(fsdp=True, data_axes=("data",))
    for shape, axes in [((6, 8), ("heads", "ffn")), ((8, 6), ("ffn", "heads")),
                        ((4, 6, 8), ("embed", "kv_heads", "q_grp")),
                        ((3, 8), ("embed", "vocab"))]:
        want = jax_param_pspec(Param(jax.ShapeDtypeStruct(shape, "float32"),
                                     axes), rules, jmesh)
        assert param_pspec(shape, axes, rules, mesh) == tuple(want)


def test_mqa_and_vocab_fallbacks():
    """MQA's single kv head is not sharded over model, and a vocab of 250
    does not divide over model = 4 (the reference's multi-device test)."""
    spec = ModelSpec(name="mqa", n_layers=1, d_model=64, n_heads=4,
                     n_kv_heads=1, d_ff=128, vocab=250)
    params = init_params(spec, RuntimeCfg(), torch.Generator(device="cpu"),
                         device="meta")
    sh = param_shardings(params, param_axes(spec),
                         logical_rules(sp=False, data_axes=("data",)),
                         {"data": 2, "model": 4})
    wk = sh["slots"][0]["attn"]["w_k"].spec
    assert len(wk) < 2 or wk[1] is None, wk
    assert all(e != "model" for e in sh["embed"].spec), sh["embed"].spec


# ---- decode caches ------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_equal_reference(name, mesh_shape, names):
    """The smoke caches (batch 4 and 32, kv_len 64): every tensor leaf's
    spec, the reference's first-dimension heuristic included (it shards a
    stack's layers dimension where the depth divides).  The port's ``pos``
    is a Python int, replicated; the reference's an array."""
    jmesh, mesh, data_axes = _meshes(mesh_shape, names)
    for batch in (4, 32):
        jcache = jax_init_cache(jax_get(name).smoke, JaxRuntimeCfg(), batch,
                                64)
        cache = init_cache(get(name).smoke, RuntimeCfg(), batch, 64,
                           device="cpu")
        want = {p: tuple(s.spec) for p, s in _jax_flat(
            jax_cache_shardings(jcache, jmesh, data_axes=data_axes)).items()}
        got = _flat(cache_shardings(cache, mesh, data_axes=data_axes))
        tensors = {p for p, t in _flat(cache).items()
                   if isinstance(t, torch.Tensor)}
        assert tensors and tensors <= set(want)
        assert {p: got[p].spec for p in tensors} == \
            {p: want[p] for p in tensors}
        assert all(got[p].spec == () for p in got if p not in tensors)


# ---- placements and meshes -----------------------------------------------------

def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert spec_placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert spec_placements((), mesh) == (Replicate(),) * 3


def test_placements_refuse_a_tuple_out_of_mesh_order():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh order"):
        spec_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="not one of"):
        spec_placements(("expert",), mesh)
    with pytest.raises(ValueError, match="two dimensions"):
        spec_placements(("model", "model"), mesh)


def test_make_mesh_needs_the_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 1), ("data", "model"))


def test_production_mesh_needs_its_world():
    """Without a process group of 256 (512) ranks, no production mesh."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="256 ranks; this one has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
