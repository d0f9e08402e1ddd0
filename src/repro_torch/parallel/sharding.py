"""Logical-axis -> mesh-axis sharding rules, own copy of
``repro.parallel.sharding`` on ``torch.distributed`` DeviceMesh / DTensor.

The same logical names the STAGE core reasons about ("vocab", "heads",
"ffn", "experts", ...) are mapped here onto mesh axes:

* model-parallel logical axes -> the ``model`` mesh axis (Megatron TP),
* batch -> ``("pod", "data")`` (DP across pods and within),
* ``act_seq`` -> ``model`` when sequence-parallelism is on,
* FSDP variant: weight ``embed`` dims additionally sharded over data.

A spec is the JAX package's ``PartitionSpec`` as a tuple: one entry per
tensor dimension, each ``None``, a mesh-axis name or a tuple of names
(major to minor), trailing ``None`` trimmed where the JAX package trims.
Every spec function takes a ``DeviceMesh`` or a plain mapping of axis name
to size (a ``DeviceMesh``'s ``.shape`` is a tuple of sizes: names come from
``mesh_dim_names``), so specs can be computed for meshes no process group
backs.  ``spec_placements`` turns a spec into DTensor placements on a real
mesh, and ``distribute`` places a tree of tensors by a tree of
``NamedSharding``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models.common import AxisRules, _tree_map


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes "
                         "a rule can name")
    return dict(zip(names, mesh.shape))


def logical_rules(*, sp: bool = True, fsdp: bool = False,
                  shard_kv_heads: bool = True,
                  data_axes: tuple = ("pod", "data"),
                  model_axis: str = "model",
                  extra: dict | None = None) -> dict[str, Any]:
    rules: dict[str, Any] = {
        "vocab": model_axis,
        "heads": model_axis,
        "kv_heads": model_axis if shard_kv_heads else None,
        "q_grp": None if shard_kv_heads else model_axis,
        "ffn": model_axis,
        "experts": model_axis,
        "embed": data_axes if fsdp else None,
        "lora": None,
        "head_dim": None,
        "state": None,
        "router": None,
        "conv": None,
        "layers": None,
        "act_batch": data_axes,
        "act_seq": model_axis if sp else None,
        "act_kv": None,
        "act_cap": data_axes,
    }
    rules.update(extra or {})
    return rules


def axis_rules(mesh, **kw) -> AxisRules:
    """``AxisRules`` over ``logical_rules(**kw)``; as in the JAX package the
    mesh is not attached (attach it as ``.mesh`` for the expert-parallel
    MoE branch)."""
    return AxisRules(logical_rules(**kw))


def _divisible(shape, axes_entry, mesh, dim: int) -> bool:
    if axes_entry is None:
        return True
    names = axes_entry if isinstance(axes_entry, (tuple, list)) \
        else (axes_entry,)
    sizes = mesh_sizes(mesh)
    deg = int(np.prod([sizes[n] for n in names]))
    return shape[dim] % deg == 0


def param_pspec(shape, axes: tuple, rules: dict, mesh) -> tuple:
    """The spec of one parameter of ``shape`` whose dimensions carry the
    logical ``axes``.  A dimension that does not divide by its mesh axes is
    left unsharded (MQA's one kv head cannot shard over model: the STG role
    rule), and a mesh axis shards one dimension at most."""
    entries: list = []
    used: set = set()
    for dim, name in enumerate(axes):
        e = rules.get(name)
        if e is not None:
            names = tuple(e) if isinstance(e, (tuple, list)) else (e,)
            names = tuple(n for n in names if n not in used)
            e = names if names else None
        if e is None or not _divisible(shape, e, mesh, dim):
            entries.append(None)
            continue
        used.update(e)
        entries.append(e if len(e) > 1 else e[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


class NamedSharding(NamedTuple):
    """A spec on a mesh: the JAX package's ``NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def spec_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dimension) of ``spec`` on the
    ``DeviceMesh`` ``mesh``.  A tensor dimension sharded over a tuple of
    mesh axes becomes ``Shard(d)`` on each of them; DTensor nests such
    shards in mesh-dimension order, so a tuple out of that order raises (no
    strided shard stands in for it).  An axis the mesh lacks, or one that
    shards two dimensions, raises too."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names or ())
    placements: list = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = e if isinstance(e, (tuple, list)) else (e,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh axis {a!r} is not one of "
                                 f"the mesh's {tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dimension {d} is sharded over {tuple(axes)}, "
                f"out of the mesh's axis order {tuple(names)}; DTensor nests "
                "shards in mesh order")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two dimensions")
            placements[i] = Shard(d)
    return tuple(placements)


def param_shardings(params, axes, rules: dict, mesh):
    """``NamedSharding`` tree matching ``params`` (anything with
    ``.shape`` as leaves) and its logical-axes tree ``axes``
    (``models.param_axes(spec)``)."""
    return _tree_map(
        lambda p, ax: NamedSharding(mesh, param_pspec(tuple(p.shape), ax,
                                                      rules, mesh)),
        params, axes)


def batch_pspec(data_axes: tuple = ("pod", "data")) -> tuple:
    return (data_axes,) if len(data_axes) != 1 else (data_axes[0],)


def cache_shardings(cache, mesh, *, model_axis: str = "model",
                    data_axes: tuple = ("pod", "data")):
    """Decode caches: dim 0 over the data axes where it divides, or dim 1
    for a stacked ``[n_rep, B, ...]`` leaf whose ``n_rep`` does not divide
    but whose B does: the JAX package's heuristic, copied as it is (it
    shards the layers dimension of a stack whose depth divides).  A leaf
    that is no tensor (``pos``) is replicated."""
    sizes = mesh_sizes(mesh)

    def spec(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return NamedSharding(mesh, ())
        entries: list = [None] * x.dim()
        deg = int(np.prod([sizes[n] for n in data_axes]))
        start = 0
        if x.dim() >= 3 and x.shape[0] != 0 and x.shape[0] % deg != 0 \
                and x.shape[1] % deg == 0:
            start = 1                       # stacked [n_rep, B, ...]
        if x.shape[start] % deg == 0:
            entries[start] = data_axes if len(data_axes) != 1 \
                else data_axes[0]
        return NamedSharding(mesh, tuple(entries))
    return _tree_map(spec, cache)


def place(t, sharding: NamedSharding):
    """``t`` as a DTensor laid out by ``sharding``: a plain tensor is cut
    into this rank's shard locally (every rank must hold the same values,
    as ``jax.device_put`` of a host array assumes; where each shard is the
    whole tensor, the DTensor shares its storage), a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor, Replicate, \
        distribute_tensor
    mesh = sharding.mesh
    placements = sharding.placements
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == placements \
            else t.redistribute(mesh, placements)
    t = t.to(torch.device(mesh.device_type, _device_index(mesh)))
    if all(mesh.size(i) == 1 for i, pl in enumerate(placements)
           if not isinstance(pl, Replicate)):
        # every shard is the whole tensor: no copy
        return DTensor.from_local(t, mesh, placements, run_check=False)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _device_index(mesh):
    if mesh.device_type == "cuda":
        return torch.cuda.current_device()
    return None


def distribute(tree, shardings):
    """``place`` over a tree: each tensor leaf with a ``NamedSharding`` at
    the same path; leaves that are no tensor (``pos``, None) stay."""
    def one(t, sh):
        if isinstance(t, torch.Tensor) and isinstance(sh, NamedSharding):
            return place(t, sh)
        return t
    return _tree_map(one, tree, shardings)
