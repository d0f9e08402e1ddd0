"""Shared helpers of the tests that hold ``repro_torch`` against ``repro``:
inputs come from numpy with a seed and go to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import RuntimeCfg as JaxRuntimeCfg
from repro.models import init_params as jax_init_params
from repro.models.common import pvalue
from repro_torch.configs import get
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


def port_spec(jspec):
    """The port's ModelSpec built from the JAX package's field by field,
    with the nested MoESpec / MLASpec / SSMSpec built the same way."""
    import dataclasses
    from repro_torch.core import MLASpec, ModelSpec, MoESpec, SSMSpec
    nested = {"moe": MoESpec, "mla": MLASpec, "ssm": SSMSpec}
    kw = {}
    for f in dataclasses.fields(jspec):
        v = getattr(jspec, f.name)
        if f.name in nested and v is not None:
            v = nested[f.name](**{g.name: getattr(v, g.name)
                                  for g in dataclasses.fields(v)})
        kw[f.name] = v
    return ModelSpec(**kw)


def port_cfg(jcfg):
    """The port's ParallelCfg with the JAX package's field values."""
    import dataclasses
    from repro_torch.core import ParallelCfg
    return ParallelCfg(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def port_engine(jspec, mode, *, batch, seq, kv_len=None):
    """The port's CompiledBackend for a JAX spec and workload, built as
    ``repro.api`` builds the JAX package's: one assembly, cloned per
    structure class.  Returns (engine, build, env, n_layers)."""
    from repro_torch.core import CompiledBackend, bind_env, build_graph, \
        total_layers
    spec = port_spec(jspec)
    env = bind_env(spec, batch=batch, seq=seq, kv_len=kv_len, mode=mode)
    src = build_graph(spec, mode=mode)

    def build():
        return src.clone().graph
    n_layers = total_layers(spec)
    return CompiledBackend(build, env, n_layers=n_layers), build, env, n_layers


def dir_bytes(path) -> dict:
    """Every file of an export directory: {name: bytes}."""
    import os
    return {fn: open(os.path.join(path, fn), "rb").read()
            for fn in sorted(os.listdir(path))}


def both_packages(jspec):
    """(package, spec) for the JAX package and the port: the same model in
    each package's own ModelSpec, so one test body runs against both."""
    import repro
    import repro_torch
    return ((repro, jspec), (repro_torch, port_spec(jspec)))


def run_both(jspec, fn) -> tuple:
    """``fn(package, spec)`` in the JAX package and in the port:
    (reference's result, port's result)."""
    ref, port = (fn(pkg, spec) for pkg, spec in both_packages(jspec))
    return ref, port


def report_rows(rep) -> tuple:
    """An analysis report as plain data: every diagnostic (code, severity,
    locus, message, fixit), the per-pass tallies and the name, with
    ``repro_torch.`` read as ``repro.``."""
    def m(x):
        return x.replace("repro_torch.", "repro.") if isinstance(x, str) \
            else x
    return ([(d.code, d.severity, d.rank, d.stage, d.phase, m(d.node),
              m(d.message), m(d.fixit)) for d in rep.diagnostics],
            dict(rep.checked), m(rep.name))


def check_both(check: str, *args, **kw):
    """The port's ``repro_torch.analysis.<check>`` and the reference's on
    the same input (files the port wrote): their reports must be equal.
    Returns the port's."""
    import repro.analysis as janalysis
    import repro_torch.analysis as analysis
    got = getattr(analysis, check)(*args, **kw)
    want = getattr(janalysis, check)(*args, **kw)
    assert report_rows(got) == report_rows(want), check
    return got


# ---------------------------------------------------------------------------
# training: the loss and its gradients in both packages
# ---------------------------------------------------------------------------

def train_batch(spec, seed, b=2, s=32):
    """tokens, labels [b, s] (and whisper's frames / internvl2's vision
    prefix [b, n, H]) from numpy with a seed: {name: array}."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, spec.vocab, size=(b, s)),
             "labels": rng.randint(0, spec.vocab, size=(b, s))}
    if spec.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (b, spec.enc_seq, spec.d_model)).astype(np.float32)
    if spec.vision_seq:
        batch["vision"] = rng.standard_normal(
            (b, spec.vision_seq, spec.d_model)).astype(np.float32)
    return batch


def jax_value_and_grad(jparams, batch, jspec, jrt):
    """The reference's loss and gradients, jitted: (loss, [grad leaves] in
    ``jax.tree.leaves`` order, as numpy)."""
    from repro.models import lm as JLM
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JLM.loss_fn(p, b, jspec, jrt)))
    loss, grads = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(pvalue(grads))]


def torch_value_and_grad(tparams, batch, tspec, trt):
    """The port's loss and gradients: (loss, [grad leaves] in the same
    order, as numpy; zeros where the loss does not reach a leaf)."""
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.tree import leaves
    loss, grads = value_and_grad(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        tspec, trt)
    return float(loss), [g.numpy() for g in leaves(grads)]


def assert_grads_close(got, want, rel=1e-4, floor=1e-6):
    """Every leaf within rel * max|want leaf| + floor."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        bound = rel * float(np.abs(w).max()) + floor
        err = float(np.abs(g - w).max())
        assert err <= bound, (i, g.shape, err, bound)


def train_runtimes(loss_chunk, remat="none"):
    """Both packages' fp32 training runtime of the grads tests: chunked
    attention in kv chunks of 16."""
    jrt, trt = runtimes(impl="chunked")
    kw = dict(attn_chunk=16, loss_chunk=loss_chunk)
    return (dataclasses.replace(jrt, remat=remat, **kw),
            dataclasses.replace(trt, remat=remat, **kw))


def check_loss_and_grads(name, loss_chunk, seed=0):
    """The smoke spec of ``name``: loss within 1e-5 relative, every
    gradient leaf within 1e-4 * max|reference leaf| + 1e-6."""
    jspec, tspec = jax_get(name).smoke, get(name).smoke
    jparams, tparams = shared_params(jspec)
    jrt, trt = train_runtimes(loss_chunk)
    batch = train_batch(tspec, seed)
    want_l, want_g = jax_value_and_grad(jparams, batch, jspec, jrt)
    got_l, got_g = torch_value_and_grad(tparams, batch, tspec, trt)
    assert np.isfinite(got_l)
    assert abs(got_l - want_l) <= 1e-5 * abs(want_l), (got_l, want_l)
    assert_grads_close(got_g, want_g)


def check_remat_equal(name):
    """none / full / dots: the same loss and gradients."""
    spec = get(name).smoke
    _, tparams = shared_params(jax_get(name).smoke)
    batch = train_batch(spec, 3)
    base_l, base_g = torch_value_and_grad(tparams, batch, spec,
                                          train_runtimes(8)[1])
    for remat in ("full", "dots"):
        l, g = torch_value_and_grad(tparams, batch, spec,
                                    train_runtimes(8, remat)[1])
        assert l == pytest.approx(base_l, rel=1e-6)
        assert_grads_close(g, base_g, rel=1e-6, floor=0.0)


# ---------------------------------------------------------------------------
# The examples and their twins (examples/ and examples_torch/)
# ---------------------------------------------------------------------------

def run_example_pair(name: str, tmp_path, twin_args=(), jax_args=(),
                     timeout=600, jax_script=None) -> tuple:
    """Run ``examples/<name>.py`` (or ``jax_script``, a copy of it, with
    ``jax_args``) and ``examples_torch/<name>.py`` (with ``twin_args``),
    both at once, each in a subprocess of its own with its own working
    directory and a shared TMPDIR under ``tmp_path``; returns their
    standard outputs as lists of lines.  Either failing fails."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    tmp = Path(tmp_path) / "tmp"
    tmp.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu",
               TMPDIR=str(tmp))
    procs = []
    scripts = (jax_script or root / "examples" / f"{name}.py",
               root / "examples_torch" / f"{name}.py")
    for pkg, script, args in (("examples", scripts[0], tuple(jax_args)),
                              ("examples_torch", scripts[1],
                               tuple(twin_args))):
        cwd = Path(tmp_path) / pkg
        cwd.mkdir(exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *args],
            env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    for pkg, proc in zip(("examples", "examples_torch"), procs):
        out, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, (pkg, name, err[-4000:])
        outs.append(out.splitlines())
    return tuple(outs)


def masked(lines: list, masks: dict) -> tuple:
    """``lines`` with each of ``masks`` ({what it hides: (regex,
    replacement)}) applied to every line, and the names of the masks that
    changed some line."""
    import re
    used = set()
    out = []
    for line in lines:
        for what, (pattern, repl) in masks.items():
            new = re.sub(pattern, repl, line)
            if new != line:
                used.add(what)
            line = new
        out.append(line)
    return out, used


def assert_same_output(name, jax_lines, torch_lines, masks=None) -> None:
    """The two outputs equal line for line once ``masks`` hide what reads a
    clock or names a temporary path; each mask must hide something in
    both, so that none is left over from a line that has gone."""
    masks = masks or {}
    want, used_j = masked(jax_lines, masks)
    got, used_t = masked(torch_lines, masks)
    assert used_j == used_t == set(masks), (name, used_j, used_t)
    assert len(got) == len(want) > 0, (name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (name, i, g, w)
