"""Multi-pod dry run of the port, its own version of
``repro.launch.dryrun``: run every (arch x shape) cell's step on the
production mesh of 16x16 ranks (and 2x16x16) without a card per rank, and
record per-device FLOPs, HBM bytes, collective bytes by kind and peak
memory next to STAGE's symbolic prediction (``stage_predict``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch granite-34b --shape train_4k [--multipod] [--device cpu]

Results append to a JSONL (default ``dryrun_results.jsonl``); cells done
(OK or SKIP) are skipped on a re-run, so ``--all`` resumes.  Fake tensors
are on the card's device type unless ``--device cpu``; without a card and
without that flag this raises.  Nothing is allocated on the card either
way.

Where the JAX package lowers and compiles, the port *runs* the step, under
``FakeTensorMode`` (tensors with shapes and no storage) on a fake process
group (backend ``"fake"``: every collective returns at once) of 256 or 512
ranks, of which this process is rank 0.  The parameters, the ZeRO-1
optimizer state, the batch and the decode cache are DTensors on the mesh
of ``launch.mesh.make_production_mesh``, placed by ``param_shardings``,
``opt_state_shardings``, ``batch_specs`` and ``_cache_shardings``.  The
step is the JAX package's: ``make_train_step(..., grad_accum=rt.grad_accum)``,
``lm.forward`` for prefill, ``lm.decode_step`` for decode, with the
``AxisRules`` carrying the mesh, so MoE takes the expert-parallel branch.
The runtime is ``RuntimeCfg(remat="full", attention_impl="chunked")``: the
JAX package's dry run runs its default chunked attention and reaches no
Pallas kernel; the port's default is its CUDA kernel, whose entry reads
``data_ptr()``, which a fake tensor has not, so this path launches none.

``_Counter`` counts what rank 0 runs, op by op on its local shards:

* ``flops_per_dev``: ``torch.utils.flop_counter``'s formulas (matrix
  products and convolutions; elementwise ops count 0, where the HLO walker
  counts 1 an element) on ops whose operands are no DTensors.  DTensor's
  sharding propagation runs the global op on fake tensors of its own the
  first time it meets a shape; those are left out (counting them too is
  the pitfall of ``FlopCounterMode`` around DTensor code);
* ``bytes_per_dev``: the operand and result bytes of every op that makes
  a tensor and is no view: eager HBM traffic, where every op reads its
  inputs from memory and writes its output there.  The JAX package counts
  at fusion boundaries (``hlo_analysis``), so it reads less;
* ``collectives``: operand bytes of each ``_c10d_functional`` collective,
  by the JAX package's kind names;
* ``peak_memory_per_dev_gb``: the most bytes of rank 0's storages alive at
  once, the arguments included (``args_gb``; ``temp_gb`` the rest).

Eager is not XLA.  The JAX package donates the parameters and optimizer
state (the cache at decode) and XLA schedules buffers; the port's step
holds the old parameters and state until it returns the new ones, keeps
what autograd saves, and frees a tensor when its last reference goes.  A
record says what the port's step holds; it does not imitate XLA.

This module owns the default process group: ``main`` (and ``run_cell``
where none exists) creates the fake group for each mesh size and destroys
it after, so one process runs both meshes.  Do not run it in a process
that has a group of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from .._device import resolve_device
from ..configs import ARCHS, SHAPES, Arch, ShapeSpec, get as get_arch
from ..core.costmodel import H100_HGX
from ..models import lm
from ..models.common import (AxisRules, Initializer, RuntimeCfg, _tree_map,
                             as_global, dt, local_shape_and_offset)
from ..parallel.sharding import (NamedSharding, logical_rules, mesh_sizes,
                                 param_shardings)
from ..train.optimizer import OptCfg, init_opt_state, opt_state_shardings
from ..train.train_step import make_train_step
from .mesh import data_axes_of, make_production_mesh
from .preflight import preflight

# one H100 SXM (core.costmodel.H100_HGX): dense bf16 FLOP/s and HBM bytes/s
PEAK_FLOPS = H100_HGX.peak_flops
HBM_BW = H100_HGX.hbm_bw
# every 16-wide mesh axis spans two 8-GPU nodes, so its collectives run at
# the rate between nodes, H100_HGX's data-axis bandwidth
LINK_BW = H100_HGX.axis_bw("dp")

DRYRUN_RT = RuntimeCfg(remat="full", attention_impl="chunked")

# _c10d_functional collectives by the JAX package's kind names
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor")
# ops of those namespaces that move no data: waiting on a collective's
# result, wrapping it for autograd
_NOT_MOVED = ("wait_tensor", "_wrap_tensor_autograd")


def arch_rules(arch: Arch, mesh, *, overrides: Optional[dict] = None,
               sp: Optional[bool] = None) -> dict:
    """Per-arch logical->mesh rules with divisibility-driven choices (the
    JAX package's); ``mesh`` a ``DeviceMesh`` or a mapping of axis sizes."""
    spec = arch.spec
    model = mesh_sizes(mesh)["model"]
    kv_ok = spec.n_kv_heads % model == 0 and spec.block not in ("mla",)
    grp_ok = (max(1, spec.n_heads // max(1, spec.n_kv_heads)) % model == 0)
    # FSDP(ZeRO-3) weights over data when attention is unshardable over
    # model (qwen3/minitron/internvl) or the model is MoE (expert weights
    # would otherwise replicate across the data axes).
    fsdp = (spec.moe is not None) or \
        not (kv_ok or grp_ok or spec.block in ("mla", "rwkv6"))
    return logical_rules(
        sp=arch.runtime.sp if sp is None else sp, fsdp=fsdp,
        shard_kv_heads=kv_ok, data_axes=data_axes_of(mesh), extra=overrides)


class _MetaInitializer(Initializer):
    """``Initializer``'s leaves as meta tensors: the same shapes and dtypes,
    nothing drawn, a stack made whole at once."""

    def __init__(self, dtype):
        self.dtype = dt(dtype)
        self.device = torch.device("meta")

    def __call__(self, name: str, shape: tuple, axes: tuple,
                 scale: Optional[float] = None, dtype=None) -> torch.Tensor:
        return torch.empty(shape, dtype=dt(dtype) if dtype is not None
                           else self.dtype, device=self.device)

    @staticmethod
    def stack(init_one, n_rep: int) -> dict:
        if not n_rep:
            return {}
        return _tree_map(lambda t: t.new_empty((n_rep,) + tuple(t.shape)),
                         init_one(0))


def abstract_params(arch: Arch, rt: RuntimeCfg) -> dict:
    """The parameter tree as meta tensors: shapes and dtypes, no storage
    (the JAX package's ``eval_shape``)."""
    return lm._build(_MetaInitializer(rt.param_dtype), arch.spec)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _data_entry(mesh):
    da = data_axes_of(mesh)
    return da if len(da) != 1 else da[0]


def batch_specs(arch: Arch, shape: ShapeSpec, mesh) -> tuple[dict, dict]:
    """(meta tensors, ``NamedSharding``s) of the data batch, batch over the
    data axes; ``mesh`` a ``DeviceMesh`` or a mapping of axis sizes."""
    spec = arch.spec
    b, s = shape.global_batch, shape.seq_len
    text_s = s - spec.vision_seq if spec.vision_seq else s
    sds = {"tokens": _meta((b, text_s), torch.int32),
           "labels": _meta((b, text_s), torch.int32)}
    if spec.encoder_layers:
        sds["frames"] = _meta((b, spec.enc_seq, spec.d_model), torch.bfloat16)
    if spec.vision_seq:
        sds["vision"] = _meta((b, spec.vision_seq, spec.d_model),
                              torch.bfloat16)
    shd = {k: NamedSharding(mesh, (_data_entry(mesh),)) for k in sds}
    return sds, shd


def input_specs(arch: Arch, shape_name: str, *, multi_pod: bool = False):
    """Public helper: meta stand-ins for every model input (no process
    group needed)."""
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    return batch_specs(arch, SHAPES[shape_name], sizes)[0]


def _cache_abstract(arch: Arch, rt: RuntimeCfg, batch: int, kv_len: int):
    return lm.init_cache(arch.spec, rt, batch, kv_len, device="meta")


def _cache_shardings(cache_abs, mesh, *, batch: int = 0,
                     seq_axis: Optional[str] = None, buggy: bool = False):
    """Decode-cache shardings.  ``buggy=True`` reproduces the naive
    'first divisible dim' heuristic (which lands on the layer-stack dim
    and forces per-layer gathers) — kept as the recorded baseline of
    §Perf iteration 1 on minitron-8b/decode_32k.  ``decode_step`` takes
    such a cache (each row broadcast from the ranks that hold it).  Else
    ``seq_axis`` (the rule override ``_cache_seq_axis``) shards the
    largest dim past the batch over that mesh axis: the kv-sequence of an
    attention cache, the channels of a recurrent state; ``decode_step``
    writes each rank's part of a span into its shard
    (``models.common.write_span``, ``ring_append``, ``copy_into``).  A leaf
    that is no tensor (``pos``) is replicated."""
    da = data_axes_of(mesh)
    sizes = mesh_sizes(mesh)
    deg = int(np.prod([sizes[a] for a in da]))

    def one(x):
        if not isinstance(x, torch.Tensor):
            return NamedSharding(mesh, ())
        entries: list = [None] * len(x.shape)
        if buggy:
            for d, sz in enumerate(x.shape):
                if sz % deg == 0 and sz > 1:
                    entries[d] = da
                    break
            return NamedSharding(mesh, tuple(entries))
        # shard the batch dim (identified by size), never the layer stack
        bdim = next((d for d, sz in enumerate(x.shape)
                     if sz == batch and sz % deg == 0), None)
        if bdim is not None:
            entries[bdim] = da
        if seq_axis is not None and len(x.shape) >= 3:
            # optionally shard the kv-seq dim (largest remaining) over model
            cand = [(sz, d) for d, sz in enumerate(x.shape)
                    if entries[d] is None and sz % sizes[seq_axis] == 0
                    and sz > 1]
            if cand:
                sz, d = max(cand)
                if sz >= 4 * sizes[seq_axis]:
                    entries[d] = seq_axis
        return NamedSharding(mesh, tuple(entries))
    return _tree_map(one, cache_abs)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists and dicts (an op's arguments and
    results), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """FLOPs, bytes, collective bytes and live storage bytes of the ops
    this rank runs on its local tensors: fake tensors of ``fake_mode``, or
    real ones where ``fake_mode`` is None.  Ops on DTensors are left to
    DTensor (``NotImplemented``), whose local ops come back here; fake
    tensors of any other mode (DTensor's sharding propagation) are not
    counted.  A storage is live from the op that makes it (or ``hold``)
    until the last tensor on it goes."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = defaultdict(float)
        self.live = 0
        self.peak = 0
        self._held: dict = {}

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        self._held[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._held.pop(key, None)
        self.live -= n

    def _ours(self, t: torch.Tensor) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        if isinstance(t, FakeTensor):
            return t.fake_mode is self.fake_mode
        return self.fake_mode is None and not t.is_meta

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(t not in (torch.Tensor, FakeTensor) for t in types):
            return NotImplemented     # a DTensor (or a collective's wrapper)
        if self.fake_mode is not None and not _tensors((args, kwargs)) \
                and torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is None:
            with self.fake_mode:      # a factory of the step: a fake tensor
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not outs or not self._ours((ins + outs)[0]):
            return out
        if func.namespace in _COLLECTIVE_NS:
            name = func._overloadpacket.__name__
            if name in _NOT_MOVED:
                return out
            self.collectives[_KINDS.get(name, name)] += \
                sum(_nbytes(t) for t in ins)
        in_st = {t.untyped_storage()._cdata for t in ins}
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if writes or any(t.untyped_storage()._cdata not in in_st
                         for t in outs):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in outs:
            self.hold(t)
        return out

    def counts(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": dict(self.collectives),
                "collective_bytes": float(sum(self.collectives.values())),
                "peak_bytes": self.peak}


# ---------------------------------------------------------------------------
# Lowering: one cell's step on a mesh
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world: int):
    """A fake default process group of ``world`` ranks (backend "fake",
    ``FakeStore``: nothing is sent), this process rank 0, destroyed on
    exit.  Where a default group exists already it is used as it is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(tree, shardings, make):
    """Each tensor leaf of ``tree`` (meta tensors) as a DTensor laid out by
    its ``NamedSharding``, its local shard ``make(shape, dtype)``; a leaf
    that is no tensor stays."""
    def one(t, sh):
        if not isinstance(t, torch.Tensor):
            return t
        pl = sh.placements
        shape, _ = local_shape_and_offset(t.shape, sh.mesh, pl)
        return as_global(make(shape, t.dtype), sh.mesh, pl, t.shape)
    return _tree_map(one, tree, shardings)


def _maker(device, fake: bool, fill: str, gen=None, vocab: int = 0):
    """Local shards: empty fake tensors, or real ones filled with ``fill``
    (``zeros``; ``normal``: N(0, 0.02) floats, tokens below ``vocab``)."""
    def make(shape, dtype):
        t = torch.empty(shape, dtype=dtype, device=device)
        if fake:
            return t
        if fill == "zeros":
            return t.zero_()
        if dtype.is_floating_point:
            return t.normal_(0.0, 0.02, generator=gen)
        return t.random_(0, max(1, vocab), generator=gen)
    return make


@dataclasses.dataclass
class Cell:
    """One cell's step and its placed arguments: fake tensors of
    ``fake_mode``, or real ones where that is None.  ``meta`` says whether
    FSDP is on, and the rules."""
    step: object
    args: tuple
    fake_mode: object
    meta: dict


def prepare(arch: Arch, shape: ShapeSpec, mesh, *,
            rt: Optional[RuntimeCfg] = None,
            rule_overrides: Optional[dict] = None,
            fake: bool = True) -> Cell:
    """The step of ``arch`` at ``shape`` on ``mesh`` and its arguments,
    placed by the rules: under ``FakeTensorMode`` (``fake=True``), or real
    on the mesh's device, random from seed 0 (a one-rank mesh of the card
    holds a cut-down model whole)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rt = rt or DRYRUN_RT
    overrides = rule_overrides or {}
    rules_d = arch_rules(arch, mesh, overrides=rule_overrides, sp=rt.sp)
    rules = AxisRules(rules_d, mesh)      # the mesh: MoE's EP branch
    spec = arch.spec
    da = data_axes_of(mesh)
    meta = {"fsdp": rules_d.get("embed") == da,
            "rules": {k: str(v) for k, v in rules_d.items()}}
    device = torch.device("cpu") if mesh.device_type == "cpu" else \
        torch.device(mesh.device_type,
                     0 if fake else torch.cuda.current_device())
    fake_mode = FakeTensorMode() if fake else None
    gen = None if fake else torch.Generator(device=device).manual_seed(0)

    # the abstract trees (meta) and their shardings, then the local shards
    params_abs = abstract_params(arch, rt)
    axes = lm.param_axes(spec)
    trees = [(params_abs, param_shardings(params_abs, axes, rules_d, mesh),
              "normal")]
    if shape.kind == "train":
        trees.append((init_opt_state(params_abs),
                      opt_state_shardings(params_abs, axes, rules_d, mesh,
                                          zero1=rt.zero1, data_axes=da),
                      "zeros"))
        trees.append(batch_specs(arch, shape, mesh) + ("normal",))
        step = make_train_step(spec, rt, OptCfg(), rules,
                               grad_accum=rt.grad_accum)
    elif shape.kind == "prefill":
        bsds, bshard = batch_specs(arch, shape, mesh)
        bsds.pop("labels")
        bshard.pop("labels")
        trees.append((bsds, bshard, "normal"))

        def step(params, batch):
            with torch.no_grad():
                return lm.forward(params, batch["tokens"], spec, rt, rules,
                                  frames=batch.get("frames"),
                                  vision=batch.get("vision"))
    else:                                            # decode
        b = shape.global_batch
        cache_abs = _cache_abstract(arch, rt, b, shape.seq_len)
        trees.append((cache_abs,
                      _cache_shardings(
                          cache_abs, mesh, batch=b,
                          seq_axis=overrides.get("_cache_seq_axis"),
                          buggy=overrides.get("_buggy_cache", True)),
                      "zeros"))
        deg = math.prod(mesh_sizes(mesh)[a] for a in da)
        trees.append((_meta((b, 1), torch.int32),
                      NamedSharding(mesh, (_data_entry(mesh),)
                                    if b % deg == 0 else ()), "normal"))

        def step(params, cache, tokens):
            return lm.decode_step(params, cache, tokens, spec, rt, rules)
    with fake_mode or contextlib.nullcontext():
        args = tuple(_placed(tree, sh, _maker(device, fake, fill, gen,
                                              spec.vocab))
                     for tree, sh, fill in trees)
    return Cell(step, args, fake_mode, meta)


def count(cell: Cell) -> dict:
    """Run ``cell``'s step once under ``_Counter``: its counts, plus
    ``args_bytes`` (the arguments' local storages, live from the start)
    and ``trace_wall_s``.  The step's result is dropped.  The fake mode is
    not entered around the step (``_Counter`` makes its factories fake):
    DTensor takes an active fake mode for tracing, and would then run every
    op's sharding propagation through it, uncached, on global shapes."""
    counter = _Counter(cell.fake_mode)
    for t in _tensors(cell.args):
        counter.hold(t.to_local())
    args_bytes = counter.live
    t0 = time.perf_counter()
    with counter:
        out = cell.step(*cell.args)
    if cell.fake_mode is None and torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del out
    counts = counter.counts()
    counts.update(args_bytes=args_bytes, trace_wall_s=wall)
    return counts


def lower_on(arch: Arch, shape: ShapeSpec, mesh, **kw) -> tuple[dict, dict]:
    """(counts, meta) of one step of ``arch`` at ``shape`` on ``mesh``:
    ``count(prepare(...))``, the helper of ``lower_cell`` that takes any
    mesh and shape (the card check runs it on a one-rank mesh)."""
    cell = prepare(arch, shape, mesh, **kw)
    return count(cell), cell.meta


# prefill: the depths (repeats of the layer period) that are run, from
# which the counts are extrapolated to the arch's depth.  Not 1: the first
# repeat's peak differs from the later ones' (at smoke size a kilobyte of
# the online softmax's state is alive at the second repeat's peak and not
# at the first's)
REPEATS = (2, 3)


def _with_repeats(arch: Arch, k: int) -> Arch:
    """``arch`` cut to ``k`` repeats of its layer period (the prefix kept)."""
    prefix, period = lm.layer_pattern(arch.spec)
    spec = dataclasses.replace(arch.spec, n_layers=prefix + k * period)
    if lm.layer_pattern(spec) != (prefix, period):
        raise ValueError(f"{arch.name}: {k} repeats change the layer pattern")
    return dataclasses.replace(arch, spec=spec)


def lower_by_repeats(arch: Arch, shape: ShapeSpec, mesh,
                     **kw) -> tuple[dict, dict]:
    """``lower_on``'s (counts, meta) from two runs cut to ``REPEATS``
    repeats of the layer period, extrapolated to the arch's repeats.  Exact
    where every repeat after the first does the same work on the same local
    shapes and the rest (prefix, encoder, embedding, logits) does not depend
    on the depth: a forward without grad, where a layer's temporaries are
    freed before the next one's (``tests/test_torch_dryrun_repeats.py``
    holds every count equal to the full loop's for every family's smoke
    spec).  The stacked parameters are never sharded over their layers
    dimension, so a repeat's local shapes do not depend on the depth
    either."""
    n = lm._n_rep(arch.spec)
    (c1, meta), (c2, _) = (lower_on(_with_repeats(arch, k), shape, mesh,
                                    **kw) for k in REPEATS)
    k1, k2 = REPEATS

    def ext(a, b):
        return a + (b - a) * (n - k1) // (k2 - k1)
    counts = {k: ext(c1[k], c2[k]) for k in
              ("flops", "bytes", "collective_bytes", "peak_bytes",
               "args_bytes")}
    counts["collectives"] = {
        kind: ext(c1["collectives"].get(kind, 0.0),
                  c2["collectives"].get(kind, 0.0))
        for kind in {**c1["collectives"], **c2["collectives"]}}
    counts["trace_wall_s"] = c1["trace_wall_s"] + c2["trace_wall_s"]
    counts["repeats"] = {"counted": list(REPEATS), "of": n}
    return counts, meta


def lower_cell(arch: Arch, shape_name: str, *, multi_pod: bool = False,
               rt: Optional[RuntimeCfg] = None,
               rule_overrides: Optional[dict] = None, device=None):
    """Run one (arch x shape) cell on the production mesh (the fake group
    of 256 or 512 ranks must exist: ``fake_group``); returns (counts, mesh,
    meta).  A prefill of more repeats than the two runs of ``REPEATS`` add
    up to is counted by ``lower_by_repeats`` (its chunked attention runs
    32 x 32 kv chunk pairs a layer at 32k tokens, each a few dozen DTensor
    ops).  Eager PyTorch
    donates nothing, so the JAX package's ``donate`` has no counterpart."""
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    lower = lower_by_repeats if shape.kind == "prefill" \
        and lm._n_rep(arch.spec) > sum(REPEATS) else lower_on
    counts, meta = lower(arch, shape, mesh, rt=rt,
                         rule_overrides=rule_overrides)
    return counts, mesh, meta


def analyze(arch: Arch, shape_name: str, counts: dict, mesh) -> dict:
    """The record of one OK cell from ``lower_on``'s counts."""
    chips = int(np.prod(list(mesh.shape)))
    flops, bytes_acc = counts["flops"], counts["bytes"]
    coll_total = counts["collective_bytes"]
    spec = arch.spec
    shp = SHAPES[shape_name]
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    model_flops = (6.0 if shp.kind == "train" else 2.0) \
        * spec.active_params() * tokens
    peak, args = counts["peak_bytes"], counts["args_bytes"]
    rec = {
        "arch": arch.name, "shape": shape_name,
        "mesh": "x".join(str(v) for v in mesh.shape),
        "chips": chips,
        "flops_per_dev": flops,
        "bytes_per_dev": bytes_acc,
        "collective_bytes_per_dev": coll_total,
        "collectives": counts["collectives"],
        "t_compute_s": flops / PEAK_FLOPS,
        "t_memory_s": bytes_acc / HBM_BW,
        "t_collective_s": coll_total / LINK_BW,
        "model_flops_total": model_flops,
        "useful_flops_ratio": model_flops / (flops * chips) if flops else 0.0,
        "peak_memory_per_dev_gb": round(peak / 2**30, 3),
        "temp_gb": round((peak - args) / 2**30, 3),
        "args_gb": round(args / 2**30, 3),
        "trace_wall_s": round(counts["trace_wall_s"], 2),
    }
    if "repeats" in counts:
        rec["repeats"] = counts["repeats"]
    dom = max(("t_compute_s", "t_memory_s", "t_collective_s"),
              key=lambda k: rec[k])
    rec["dominant"] = dom.replace("t_", "").replace("_s", "")
    return rec


def stage_predict(arch: Arch, shape_name: str, *, multi_pod: bool = False,
                  fsdp: bool = False, zero1: bool = True) -> dict:
    """Symbolic STAGE estimate for one dry-run cell (Scenario pipeline) on
    H100s: predicted step time / peak memory on the production mesh,
    recorded next to the counted numbers for fidelity tracking.  Mirrors
    the runtime strategy: experts shard over the model ("tp") axis like the
    EP branch, and optimizer state follows ``rt.zero1``."""
    shp = SHAPES[shape_name]
    return preflight(arch.spec, mode=shp.kind, batch=shp.global_batch,
                     seq=shp.seq_len, dp=32 if multi_pod else 16, tp=16,
                     sp=True, fsdp=fsdp, zero1=zero1,
                     ep="tp" if arch.spec.moe is not None else False,
                     hw=H100_HGX)


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             out_path: str, rt: Optional[RuntimeCfg] = None,
             label: str = "", device=None,
             rule_overrides: Optional[dict] = None) -> dict:
    """One cell's record, appended to ``out_path``: SKIP where the arch
    skips the shape, FAIL with the error and its trace where the step
    raised, else OK.  Creates the fake group where none exists.
    ``rule_overrides`` goes to ``prepare`` (a variant: give it a
    ``label``, which also keeps ``--all`` from taking it for the cell)."""
    arch = get_arch(arch_name)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    if shape_name in arch.skip:
        rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
               "status": "SKIP", "reason": arch.skip[shape_name]}
    else:
        t0 = time.time()
        try:
            with fake_group(512 if multi_pod else 256):
                counts, mesh, meta = lower_cell(
                    arch, shape_name, multi_pod=multi_pod, rt=rt,
                    rule_overrides=rule_overrides, device=device)
            rec = analyze(arch, shape_name, counts, mesh)
            rec["status"] = "OK"
            try:
                rec["stage_predict"] = stage_predict(
                    arch, shape_name, multi_pod=multi_pod,
                    fsdp=bool(meta.get("fsdp")), zero1=(rt or DRYRUN_RT).zero1)
            except Exception as e:  # noqa: BLE001 — advisory only
                rec["stage_predict"] = {"error": f"{type(e).__name__}: {e}"}
        except Exception as e:  # noqa: BLE001 — record and continue sweep
            rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:],
                   "trace_wall_s": round(time.time() - t0, 2)}
    if label:
        rec["label"] = label
    with open(out_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


def done_cells(out_path: str) -> set:
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("OK", "SKIP") and not r.get("label"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def summary(out_path: str) -> str:
    """The records of ``out_path`` as a markdown table, one row a cell:
    status, trace seconds, per-device TFLOPs, GiB moved, collective GiB by
    kind, peak GiB (args), and two ratios against ``stage_predict``: the
    roofline step (the largest of ``t_compute_s``, ``t_memory_s`` and
    ``t_collective_s``) over its ``step_ms``, the peak over its
    ``peak_gb`` (GiB, as the record's).  A cell not OK shows its reason."""
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
    rows = ["| arch · shape · mesh | status | trace s | TFLOP / dev | "
            "GiB moved / dev | collective GiB: AG / AR / RS / A2A | "
            "peak GiB (args) | roofline ÷ STAGE step | peak ÷ STAGE peak |",
            "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    with open(out_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    for r in records:
        cell = f"{r['arch']} · {r['shape']} · {r['mesh']}"
        if r["status"] != "OK":
            why = " ".join((r.get("reason") or r.get("error", "")).split())
            why = why[:120].replace("|", "/")
            rows.append(f"| {cell} | {r['status']} | "
                        f"{r.get('trace_wall_s', '')} | {why} | | | | | |")
            continue
        stage = r.get("stage_predict") or {}
        step_ms = 1e3 * max(r["t_compute_s"], r["t_memory_s"],
                            r["t_collective_s"])
        coll = " / ".join(f"{r['collectives'].get(k, 0.0) / 2**30:.3g}"
                          for k in kinds)
        ratios = [f"{a / b:.3g}" if b else "—" for a, b in (
            (step_ms, stage.get("step_ms")),
            (r["peak_memory_per_dev_gb"], stage.get("peak_gb")))]
        rows.append(
            f"| {cell} | OK | {r['trace_wall_s']} | "
            f"{r['flops_per_dev'] / 1e12:.4g} | "
            f"{r['bytes_per_dev'] / 2**30:.4g} | {coll} | "
            f"{r['peak_memory_per_dev_gb']:.4g} ({r['args_gb']:.4g}) | "
            f"{ratios[0]} | {ratios[1]} |")
    return "\n".join(rows)


# the JAX package's two variants of minitron-8b decode_32k
# (benchmarks/perf_iterations.py): {name: (label, rule overrides)}
VARIANTS = {
    "m1": ("m1-cache-batch-shard", {"_buggy_cache": False}),
    "m2": ("m2-m1+cache-seq-over-model",
           {"_buggy_cache": False, "_cache_seq_axis": "model"}),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' (fake tensors either way)")
    ap.add_argument("--summary", action="store_true",
                    help="print the records of --out as a markdown table")
    ap.add_argument("--variant", choices=sorted(VARIANTS), default=None,
                    help="one cell as a variant: m1 the cache by batch, m2 "
                         "by batch with its kv-sequence over model (the "
                         "record carries the variant's label)")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(args.out))
        return
    if args.variant and args.all:
        ap.error("--variant names one cell, not --all")
    resolve_device(args.device)        # no card and no --device cpu: raise

    if args.all:
        done = done_cells(args.out)
        for mp in (False, True):
            mesh_tag = "2x16x16" if mp else "16x16"
            with fake_group(512 if mp else 256):
                for a in ARCHS:
                    for s in SHAPES:
                        if (a, s, mesh_tag) in done:
                            continue
                        t0 = time.time()
                        rec = run_cell(a, s, multi_pod=mp, out_path=args.out,
                                       device=args.device)
                        print(f"[{time.strftime('%H:%M:%S')}] {a} {s} "
                              f"{mesh_tag}: {rec['status']} "
                              f"({time.time() - t0:.1f}s)", flush=True)
        return
    if args.arch is None or args.shape is None:
        ap.error("one cell needs --arch and --shape (or --all)")
    label, overrides = VARIANTS[args.variant] if args.variant else ("", None)
    rec = run_cell(args.arch, args.shape, multi_pod=args.multipod,
                   out_path=args.out, device=args.device, label=label,
                   rule_overrides=overrides)
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
