"""The port's checkpoints against the JAX package's: every checkpoint test of
``tests/test_ckpt_stragglers.py`` on the port (bit-exact round trips per
dtype, the typed errors, the manager's policy), the reference's quirks held
in both packages, the leaf -> logical-axes map against ``paxes``, both
packages loading each other's checkpoints bit for bit with equal
manifests, and a resumed run against an uninterrupted one, within one
package and across them.

Tolerances, each stated where it is used: a resumed loss within 1e-4
relative of the uninterrupted one (the reference's test); a step in the
port after two under JAX within 1e-4 * max|reference leaf| + 1e-6 (the
train tests' bound).  Everything else is bit for bit."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore as jax_restore
from repro.ckpt import save as jax_save
from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.ckpt import ManifestMismatchError as JaxManifestMismatchError
from repro.configs import ARCHS
from repro.configs import get as jax_get
from repro.core import ModelSpec as JaxModelSpec
from repro.models import RuntimeCfg as JaxRuntimeCfg
from repro.models import init_params as jax_init_params
from repro.models.common import Param, paxes, pvalue
from repro.train import OptCfg as JaxOptCfg
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import ModelSpec, ParallelCfg
from repro_torch.ckpt import (CheckpointError, CheckpointManager,
                              ManifestMismatchError, TemplateMismatchError,
                              latest_step, restore, save)
from repro_torch.configs import get
from repro_torch.data import DataCfg, TokenPipeline
from repro_torch.ft import elastic_mesh_shape, shrink_cfg
from repro_torch.models import RuntimeCfg, init_params, param_axes
from repro_torch.models.convert import params_from_reference
from repro_torch.train import OptCfg, init_opt_state, make_train_step
from repro_torch.train.tree import leaves
from torch_port_helpers import assert_grads_close, runtimes, shared_params

DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
AXES = {"layers": [{"w": ("d_model", "d_ff"), "b": ("d_ff",)}]}


def _state(dtype="float32"):
    dt = getattr(torch, dtype)
    return {
        "layers": [
            {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4).to(dt),
             "b": torch.zeros(4).to(dt)},
        ],
        "step_marker": torch.tensor(7, dtype=torch.int32),
        "frozen": None,
    }


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def _jax_bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


# ---- roundtrips -----------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_save_restore_roundtrip_dtypes(tmp_path, dtype):
    state = _state(dtype)
    save(str(tmp_path), 5, state, axes=AXES)
    restored, step = restore(str(tmp_path), state, device="cpu")
    assert step == 5
    assert restored["frozen"] is None
    for a, b in zip(leaves(state), leaves(restored)):
        if a is None:
            continue
        assert a.dtype == b.dtype          # view dtypes survive npz
        assert a.shape == b.shape and _bits(a) == _bits(b)


def test_restore_places_on_the_device_asked(tmp_path, monkeypatch):
    """The port's counterpart of the reference's ``shardings``: ``device``.
    The CPU when asked; without a card the default raises."""
    state = _state()
    save(str(tmp_path), 1, state)
    restored, _ = restore(str(tmp_path), state, device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(restored)
               if t is not None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore(str(tmp_path), state)


def test_elastic_restore_smaller_mesh(tmp_path):
    """The checkpoint stores logical axes, not device ids: state written
    under one parallel config restores under a shrunken one (the
    elastic path after an eviction)."""
    cfg = ParallelCfg(axes={"dp": 4, "tp": 2}, dp_axis="dp", tp_axis="tp",
                      sp=True, pp=2)
    state = _state()
    d = save(str(tmp_path), 10, state, axes=AXES,
             n_hosts=cfg.world // 8 or 1)
    small = shrink_cfg(cfg, 8)             # dp 4 -> 2, model mesh intact
    assert small.world == 8
    restored, step = restore(str(tmp_path), state, device="cpu")
    assert step == 10
    assert torch.equal(restored["layers"][0]["w"], state["layers"][0]["w"])
    man = json.load(open(os.path.join(d, "manifest.json")))
    axes = {e["path"]: e.get("axes") for e in man["entries"]}
    assert axes["/layers/0/w"] == ["d_model", "d_ff"]
    assert axes["/step_marker"] is None and "/frozen" in axes
    assert elastic_mesh_shape(small.world, model=4) == (2, 4)


# ---- typed errors ---------------------------------------------------------

def test_template_mismatch_is_typed_with_path(tmp_path):
    state = _state()
    save(str(tmp_path), 2, state)
    bigger = dict(state)
    bigger["extra"] = torch.ones(2)
    with pytest.raises(TemplateMismatchError) as ei:
        restore(str(tmp_path), bigger, device="cpu")
    assert ei.value.path == "/extra"
    assert isinstance(ei.value, CheckpointError)
    assert "/extra" in str(ei.value)


def _edit_manifest(d, field, value):
    mpath = os.path.join(d, "manifest.json")
    man = json.load(open(mpath))
    ent = next(e for e in man["entries"] if e["path"].endswith("/w"))
    ent[field] = value
    json.dump(man, open(mpath, "w"))
    return ent["path"]


@pytest.mark.parametrize("field,value,match", [
    ("dtype", "float64", "float64"), ("shape", [4, 3], "shape")])
def test_manifest_mismatch_rejected(tmp_path, field, value, match):
    """A manifest rewritten out of band: the dtype or the shape it records
    no longer matches the leaf, in both packages alike."""
    state = _state()
    path = _edit_manifest(save(str(tmp_path / "port"), 3, state), field,
                          value)
    with pytest.raises(ManifestMismatchError, match=match) as ei:
        restore(str(tmp_path / "port"), state, device="cpu")
    assert ei.value.path == path
    jstate = _jax_small_state()
    _edit_manifest(jax_save(str(tmp_path / "jax"), 3, jstate), field, value)
    with pytest.raises(ManifestMismatchError, match=match):
        restore(str(tmp_path / "jax"), state, device="cpu")
    with pytest.raises(JaxManifestMismatchError, match=match):
        jax_restore(str(tmp_path / "jax"), jstate)


def test_axes_must_fit_the_state(tmp_path):
    state = _state()
    with pytest.raises(CheckpointError, match="lacks"):
        save(str(tmp_path), 1, state, axes={"nowhere": ("d",)})
    with pytest.raises(CheckpointError, match="axes"):
        save(str(tmp_path), 1, state,
             axes={"layers": [{"w": ("d_model",)}]})


# ---- manager policy -------------------------------------------------------

def test_maybe_save_skips_step_zero(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=10)
    state = _state()
    assert mgr.maybe_save(0, state) is None          # init state: no ckpt
    assert latest_step(str(tmp_path)) is None
    assert mgr.maybe_save(5, state) is None          # off-cadence
    assert mgr.maybe_save(10, state, axes=AXES) is not None
    assert mgr.resume(state, device="cpu")[1] == 10


def test_keep_n_rotation_order(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=1)
    state = _state()
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, state)
    steps = sorted(int(f.split("_")[1]) for f in os.listdir(tmp_path))
    assert steps == [3, 4]
    restored, step = mgr.resume(state, device="cpu")
    assert step == 4 and restored is not None
    assert CheckpointManager(str(tmp_path / "empty")).resume(state) \
        == (None, 0)


# ---- the reference's quirks, mirrored (held in both packages) -----------

def _jax_small_state():
    return {"layers": [{"w": Param(np.arange(12, dtype=np.float32)
                                   .reshape(3, 4), ("d_model", "d_ff")),
                        "b": Param(np.zeros(4, np.float32), ("d_ff",))}],
            "step_marker": np.asarray(7, dtype=np.int32), "frozen": None}


def test_keep_zero_deletes_nothing(tmp_path):
    """``keep=0``: ``steps[:-0]`` is empty, so the manager deletes
    nothing (``src/repro/ckpt/checkpoint.py:229-235``)."""
    for pkg, mgr_cls, state in (("port", CheckpointManager, _state()),
                                ("jax", JaxCheckpointManager,
                                 _jax_small_state())):
        mgr = mgr_cls(str(tmp_path / pkg), keep=0, every=1)
        for s in (1, 2, 3):
            mgr.maybe_save(s, state)
        assert sorted(os.listdir(tmp_path / pkg)) == [
            "step_00000001", "step_00000002", "step_00000003"], pkg


def test_extra_checkpoint_paths_are_ignored(tmp_path):
    """A path the checkpoint has and the template lacks raises nothing and
    is left out (the error's docstring says "or vice versa";
    ``checkpoint.py:32-41,89-106``)."""
    state = _state()
    save(str(tmp_path / "port"), 1, state)
    smaller = {"layers": state["layers"]}
    restored, _ = restore(str(tmp_path / "port"), smaller, device="cpu")
    assert sorted(restored) == ["layers"]
    jstate = _jax_small_state()
    jax_save(str(tmp_path / "jax"), 1, jstate)
    jrestored, _ = jax_restore(str(tmp_path / "jax"),
                               {"layers": jstate["layers"]})
    assert sorted(jrestored) == ["layers"]


def test_save_reuses_a_leftover_tmp_dir(tmp_path):
    """A ``step_<k>.tmp`` left by a crashed save is written into and
    committed with whatever it held (``checkpoint.py:117``)."""
    for pkg, save_fn, state in (("port", save, _state()),
                                ("jax", jax_save, _jax_small_state())):
        tmp = tmp_path / pkg / "step_00000004.tmp"
        tmp.mkdir(parents=True)
        (tmp / "leftover").write_text("x")
        final = save_fn(str(tmp_path / pkg), 4, state)
        assert sorted(os.listdir(final)) == ["host0.npz", "leftover",
                                             "manifest.json"], pkg
        assert latest_step(str(tmp_path / pkg)) == 4


# ---- the leaf -> logical-axes map ------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_param_axes_equal_reference(name):
    """``param_axes`` equals ``paxes(init_params(...))`` leaf for leaf, at
    published size (the reference through ``eval_shape``: nothing drawn)
    and at smoke size, and has ``init_params``' structure."""
    for attr in ("spec", "smoke"):
        jspec = getattr(jax_get(name), attr)
        want = paxes(jax.eval_shape(
            functools.partial(jax_init_params, jspec, JaxRuntimeCfg()),
            jax.random.PRNGKey(0)))
        assert param_axes(getattr(get(name), attr)) == want, (name, attr)
    spec = get(name).smoke
    params = init_params(spec, RuntimeCfg(), device="cpu")
    axes = param_axes(spec, RuntimeCfg())
    flat_axes = []

    def rec(node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, list):
            for v in node:
                rec(v)
        else:
            flat_axes.append(node)
    rec(axes)
    assert [len(a) for a in flat_axes] == [t.dim() for t in leaves(params)]


# ---- checkpoints across the packages --------------------------------------

def _cross_states(name, seed=0):
    """The same ``{"params", "opt"}`` state in both packages: the smoke
    spec's parameters in the reference's ``Param`` tree (structure, axes and
    dtypes from ``eval_shape`` of its ``init_params``: bf16, the router and
    A_log fp32), fp32 moments, an int32 step and an error-feedback buffer
    in the parameters' dtypes, as the reference's compression leaves it;
    values from numpy with a seed."""
    jspec = jax_get(name).smoke
    abstract = jax.eval_shape(
        functools.partial(jax_init_params, jspec, JaxRuntimeCfg()),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(shape, dtype):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)
    jparams = jax.tree.map(lambda p: Param(draw(p.shape, p.value.dtype),
                                           p.axes),
                           abstract, is_leaf=lambda x: isinstance(x, Param))
    raw = pvalue(jparams)
    opt = {"m": jax.tree.map(lambda a: draw(a.shape, np.float32), raw),
           "v": jax.tree.map(lambda a: np.abs(draw(a.shape, np.float32)),
                             raw),
           "ef": jax.tree.map(lambda a: draw(a.shape, a.dtype), raw)}
    jstate = {"params": jparams,
              "opt": {**opt, "step": np.asarray(3, np.int32)}}
    tstate = {"params": params_from_reference(raw, device="cpu"),
              "opt": {k: params_from_reference(t, device="cpu")
                      for k, t in opt.items()}}
    tstate["opt"]["step"] = torch.tensor(3, dtype=torch.int32)
    return jstate, tstate, get(name).smoke


def _manifest(d):
    return json.load(open(os.path.join(d, "manifest.json")))


@pytest.mark.parametrize("name", ARCHS)
def test_checkpoints_cross_both_ways(tmp_path, name):
    """One state saved by each package: equal manifests (as parsed JSON),
    the same npz keys and bytes, and each package restores the other's
    bit for bit (the reference against its ``Param`` template, keeping
    the axes)."""
    jstate, tstate, spec = _cross_states(name)
    jdir = jax_save(str(tmp_path / "jax"), 7, jstate)
    tdir = save(str(tmp_path / "port"), 7,
                tstate, axes={"params": param_axes(spec)})
    assert _manifest(tdir) == _manifest(jdir)
    with np.load(os.path.join(jdir, "host0.npz")) as a, \
            np.load(os.path.join(tdir, "host0.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() \
                == b[k].tobytes(), k

    got, step = restore(str(tmp_path / "jax"), tstate, device="cpu")
    assert step == 7
    assert [t.dtype for t in leaves(got)] == [t.dtype
                                              for t in leaves(tstate)]
    assert [_bits(t) for t in leaves(got)] == [_bits(t)
                                               for t in leaves(tstate)]

    jgot, step = jax_restore(str(tmp_path / "port"), jstate)
    assert step == 7
    assert paxes(jgot["params"]) == paxes(jstate["params"])
    want, have = jax.tree.leaves(jstate), jax.tree.leaves(jgot)
    assert [np.asarray(a).dtype for a in have] \
        == [np.asarray(a).dtype for a in want]
    assert [_jax_bits(a) for a in have] == [_jax_bits(a) for a in want]


# ---- resume ---------------------------------------------------------------

SPEC_KW = dict(name="m100k", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab=256)


def _pipeline(B=8, S=32):
    return TokenPipeline(DataCfg(global_batch=B, seq_len=S,
                                 vocab=SPEC_KW["vocab"], seed=7))


def test_resume_reproduces_training(tmp_path):
    """The reference's test on the port: crash at step 5, resume from the
    checkpoint -> the step-10 loss of the uninterrupted run (rtol 1e-4)."""
    spec = ModelSpec(**SPEC_KW)
    rt = RuntimeCfg(attention_impl="naive")
    pipe = _pipeline()
    step = make_train_step(spec, rt, OptCfg(lr=5e-3))

    def run(params, opt, start, end):
        for i in range(start, end):
            batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
            params, opt, m = step(params, opt, batch)
        return params, opt, float(m["loss"])

    p0 = init_params(spec, rt, device="cpu")
    _, _, loss_a = run(p0, init_opt_state(p0), 0, 10)
    p5, o5, _ = run(p0, init_opt_state(p0), 0, 5)
    save(str(tmp_path), 5, {"params": p5, "opt": o5},
         axes={"params": param_axes(spec)})
    restored, s = restore(str(tmp_path), {"params": p5, "opt": o5},
                          device="cpu")
    assert s == 5
    _, _, loss_b = run(restored["params"], restored["opt"], s, 10)
    np.testing.assert_allclose(loss_a, loss_b, rtol=1e-4)


# eps 1e-3: Adam's first update g / (|g| + eps) moves by at most 1/eps
# times a gradient's last digits (the train tests' optimizer)
STEP_OPT = dict(lr=1e-2, warmup=2, eps=1e-3)


def test_jax_checkpoint_steps_on_in_the_port(tmp_path):
    """Two steps under JAX, saved by the JAX package; restored in the port
    and stepped once there: the parameters and moments equal the
    reference's third step within 1e-4 * max|leaf| + 1e-6 (fp32, chunked
    attention in chunks of 16), the loss within 1e-5 relative."""
    jspec, tspec = JaxModelSpec(**SPEC_KW), ModelSpec(**SPEC_KW)
    jrt, trt = runtimes(impl="chunked")
    jrt = dataclasses.replace(jrt, attn_chunk=16)
    trt = dataclasses.replace(trt, attn_chunk=16)
    jparams, tparams = shared_params(jspec)
    jopt = jax_init_opt_state(jparams)
    jstep = jax.jit(jax_make_train_step(jspec, jrt, JaxOptCfg(**STEP_OPT)))
    pipe = _pipeline()

    def jbatch(i):
        return {k: jnp.asarray(v) for k, v in pipe.batch(i).items()}
    for i in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, jbatch(i))
    jax_save(str(tmp_path), 2, {"params": jparams, "opt": jopt})
    want_p, want_o, want_m = jstep(jparams, jopt, jbatch(2))

    template = {"params": tparams, "opt": init_opt_state(tparams)}
    state, at = restore(str(tmp_path), template, device="cpu")
    assert at == 2 and int(state["opt"]["step"]) == 2
    step = make_train_step(tspec, trt, OptCfg(**STEP_OPT))
    got_p, got_o, got_m = step(state["params"], state["opt"],
                               {k: torch.from_numpy(v)
                                for k, v in pipe.batch(2).items()})
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]),
                                                 rel=1e-5)
    assert_grads_close([t.numpy() for t in leaves(got_p)],
                       [np.asarray(a)
                        for a in jax.tree.leaves(pvalue(want_p))])
    for key in ("m", "v"):
        assert_grads_close([t.numpy() for t in leaves(got_o[key])],
                           [np.asarray(a)
                            for a in jax.tree.leaves(want_o[key])],
                           floor=1e-9)
    assert int(got_o["step"]) == int(want_o["step"]) == 3
