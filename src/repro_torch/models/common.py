"""Shared model infrastructure of the port: runtime config, the parameter
initializer, and sharding constraints by logical axes.

Parameters are ``torch.Tensor`` leaves in nested dicts/lists with the same
keys and shapes as the JAX package's tree, so weights carry across leaf by
leaf (``models/convert.py``).  Every leaf is created with its logical axes,
as in the JAX package; the port keeps them apart from the tensors, in a
tree of the same structure (``lm.param_axes``, built by running the same
init functions through ``AxesInitializer``).  ``repro_torch.parallel``
maps logical names onto the axes of a ``DeviceMesh``; placed there, the
leaves are DTensors, and ``constrain`` redistributes an activation to the
placements its logical axes ask for (the JAX package's
``with_sharding_constraint``).  On plain tensors it does nothing.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .._device import torch_dtype

PyTree = Any


@dataclass(frozen=True)
class RuntimeCfg:
    """Runtime knobs orthogonal to the architecture itself; the JAX
    package's fields under its names.  ``sp``, ``zero1`` and ``grad_accum``
    are read by the dry run (``launch.dryrun``), which passes them to the
    sharding rules, ``train.opt_state_shardings`` and
    ``train.make_train_step``.  ``scan_layers`` and ``logical_rules`` are
    read by nothing, in the JAX package as here: the port loops over the
    layers of a stack."""
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # "cuda": the hand-written kernels, forward only (their plain versions
    # for CPU tensors); "chunked": online-softmax attention and the RWKV6
    # chunk loop in plain PyTorch, what training runs; "naive": materialised
    # scores, the reference the kernel is held against
    attention_impl: str = "cuda"
    attn_chunk: int = 1024              # kv-chunk for online-softmax attention
    attn_q_block: bool = True           # block queries by attn_chunk too
    remat: str = "none"                 # none | full | dots
    scan_layers: bool = True
    sp: bool = True                     # sequence-parallel activation layout
    zero1: bool = True                  # shard optimizer state over data axes
    grad_accum: int = 1
    loss_chunk: int = 0                 # >0: CE loss over seq chunks
    moe_capacity: float = 1.25          # expert capacity factor
    logical_rules: tuple = ()           # overrides for logical->mesh mapping


def dt(name) -> torch.dtype:
    return torch_dtype(name)


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists/tuples (lists out)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _check_axes(name: str, shape: tuple, axes: tuple) -> None:
    if len(axes) != len(shape):
        raise ValueError(f"{name}: {len(shape)} dimensions {shape} but axes "
                         f"{axes}")


class Initializer:
    """Deterministic fan-in-scaled normal init on an explicit
    ``torch.Generator``.  Leaves of one dimension are ones (norm scales).
    Normals are drawn in fp32 on the generator's device and cast, so no
    leaf ever exists on the host.  ``axes`` (one logical name per
    dimension) is checked and not stored: ``AxesInitializer`` collects it."""

    def __init__(self, generator: torch.Generator, dtype,
                 device: Optional[torch.device] = None):
        self.generator = generator
        self.dtype = dt(dtype)
        self.device = torch.device(device if device is not None
                                   else generator.device)

    def __call__(self, name: str, shape: tuple, axes: tuple,
                 scale: Optional[float] = None, dtype=None) -> torch.Tensor:
        _check_axes(name, shape, axes)
        out_dtype = dt(dtype) if dtype is not None else self.dtype
        if len(shape) <= 1:
            return torch.ones(shape, dtype=out_dtype, device=self.device)
        fan_in = shape[0]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        val = torch.randn(shape, generator=self.generator,
                          dtype=torch.float32, device=self.device)
        return val.mul_(std).to(out_dtype)

    @staticmethod
    def stack(init_one, n_rep: int) -> dict:
        """``n_rep`` subtrees ``init_one(r)`` stacked ``[n_rep, ...]``,
        filled one layer at a time so that the fp32 draw of only one layer
        is alive beside the stack."""
        stack: dict = {}
        for r in range(n_rep):
            rep = init_one(r)
            if r == 0:
                stack = _tree_map(
                    lambda t: torch.empty((n_rep,) + tuple(t.shape),
                                          dtype=t.dtype, device=t.device),
                    rep)
            _tree_map(lambda dst, src: dst[r].copy_(src), stack, rep)
        return stack


class AxesInitializer:
    """``Initializer``'s stand-in that builds no tensor: each call returns
    the leaf's logical axes, and ``stack`` prepends ``"layers"`` to every
    leaf of a stacked subtree, as the JAX package's ``lm._stack`` does.  Run
    through the init functions that build the parameter tree, it builds the
    tree of axes, so the two trees cannot drift apart."""

    def __call__(self, name: str, shape: tuple, axes: tuple,
                 scale: Optional[float] = None, dtype=None) -> tuple:
        _check_axes(name, shape, axes)
        return tuple(axes)

    @staticmethod
    def stack(init_one, n_rep: int) -> dict:
        return _prepend_layers(init_one(0)) if n_rep else {}


def _prepend_layers(node):
    if isinstance(node, dict):
        return {k: _prepend_layers(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_prepend_layers(v) for v in node]
    return ("layers",) + node


# ---------------------------------------------------------------------------
# Activation sharding constraints via logical names
# ---------------------------------------------------------------------------

class AxisRules:
    """Maps logical axis names -> mesh axes (or None).  ``mesh`` (a
    ``DeviceMesh``, or None) switches on the expert-parallel branch of the
    MoE FFN, as the JAX package's ``rules.mesh`` does."""

    def __init__(self, rules: dict[str, Any] | None, mesh=None):
        self.rules = dict(rules or {})
        self.mesh = mesh

    def spec(self, axes: tuple) -> tuple:
        """The spec (``parallel.sharding``'s tuple form of a
        ``PartitionSpec``) of an activation with logical ``axes``: a mesh
        axis goes to the first dimension that names it and to no later one
        (with sequence parallelism q's sequence takes ``model`` and its kv
        heads get nothing).  Trailing unsharded dimensions are trimmed, but
        not one whose mesh axes were all taken, as in the JAX package."""
        phys: list = []
        used: set = set()
        for a in axes:
            m = self.rules.get(a)
            if m is None:
                phys.append(None)
                continue
            ms = tuple(m) if isinstance(m, (tuple, list)) else (m,)
            ms = tuple(x for x in ms if x not in used)
            used.update(ms)
            phys.append(ms if len(ms) != 1 else ms[0])
        while phys and phys[-1] is None:
            phys.pop()
        return tuple(None if e == () else e for e in phys)


def constrain(x: torch.Tensor, rules: Optional[AxisRules],
              axes: tuple) -> torch.Tensor:
    """``x`` redistributed to the placements of ``rules.spec(axes)`` on its
    own mesh; a no-op without rules or for a plain tensor."""
    from torch.distributed.tensor import DTensor
    if rules is None or not isinstance(x, DTensor):
        return x
    from ..parallel.sharding import spec_placements
    return settle(x, spec_placements(rules.spec(axes), x.device_mesh))


def settle(x, placements):
    """The DTensor ``x`` redistributed to ``placements``, but on a mesh
    dimension of one rank, where every layout holds the whole tensor, ``x``
    keeps its own (no copy, no collective)."""
    mesh = x.device_mesh
    target = tuple(cur if mesh.size(i) == 1 else pl for i, (cur, pl)
                   in enumerate(zip(x.placements, placements)))
    if target == tuple(x.placements):
        return x
    return x.redistribute(mesh, target)


def whole_on_single(placements, mesh) -> tuple:
    """``placements`` with ``Replicate`` on every mesh dimension of one
    rank: the layout of a result computed from ``settle``d operands."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if mesh.size(i) == 1 else pl
                 for i, pl in enumerate(placements))


def mesh_of(tree) -> Any:
    """The ``DeviceMesh`` of ``tree``'s first tensor leaf, None if that is
    a plain tensor (a tree is placed on a mesh whole or not at all)."""
    from torch.distributed.tensor import DTensor
    t = _first_tensor(tree)
    return t.device_mesh if isinstance(t, DTensor) else None


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def whole(t):
    """A DTensor gathered whole into a plain tensor (every rank gets it); a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def as_global(local: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local``, laid out by ``placements`` (replicated on a mesh dimension of
    one rank, where the shard is the whole dimension)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, whole_on_single(placements, mesh),
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


def local_shape_and_offset(shape, mesh, placements) -> tuple:
    """(shape, offset) of this rank's shard of a tensor of global ``shape``
    laid out on ``mesh`` by ``placements``: DTensor's even split (chunks of
    ceil(n / ranks), the last ones shorter or empty), nested in mesh order.
    Plain Python on the mesh coordinate, so it runs under
    ``FakeTensorMode`` too."""
    from torch.distributed.tensor import Shard
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, k = shape[pl.dim], mesh.size(i)
            step = -(-n // k)
            lo = min(step * coord[i], n)
            shape[pl.dim] = min(lo + step, n) - lo
            offset[pl.dim] += lo
    return tuple(shape), tuple(offset)


def replicated(t, mesh):
    """A plain tensor ``t`` (tokens, labels, positions, frames, which every
    rank holds whole) as a replicated DTensor on ``mesh``; a DTensor, None,
    or any tensor when ``mesh`` is None passes through."""
    from torch.distributed.tensor import DTensor, Replicate
    if mesh is None or t is None or isinstance(t, DTensor) \
            or not isinstance(t, torch.Tensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the rows of a [V, H] table for integer ids.  On a mesh
    the lookup runs on local shards, as Megatron's vocab-parallel
    embedding, and not through DTensor's rules for indexing by a sharded
    index (torch 2.11's fail: the backward's ``index_put`` where the ids are
    sharded over one mesh axis, the lookup itself where over two).  The
    table keeps its vocab shards and gathers the rest (FSDP's embed dim);
    each rank looks up the ids in its vocab range and gives zeros for the
    others, so the result is a partial sum over the vocab's mesh axes and
    is sharded as the ids elsewhere; the table's gradient is summed over
    the ids' mesh axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    ids = replicated(ids, mesh)
    t_pl, i_pl, grad_pl, out_pl = [], [], [], []
    for i, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        if mesh.size(i) == 1:          # every layout is the whole tensor
            t_pl.append(tp)
            i_pl.append(ip)
            grad_pl.append(tp)
            out_pl.append(Replicate())
        elif isinstance(tp, Shard) and tp.dim == 0:          # vocab
            t_pl.append(tp)
            i_pl.append(Replicate())
            grad_pl.append(tp)
            out_pl.append(Partial())
        else:
            t_pl.append(Replicate())
            i_pl.append(ip)
            grad_pl.append(Partial() if isinstance(ip, Shard)
                           else Replicate())
            out_pl.append(ip)
    table, ids = settle(table, t_pl), settle(ids, i_pl)
    local, idx = table.to_local(grad_placements=grad_pl), ids.to_local()
    if local.shape[0] == table.shape[0]:                     # all the vocab
        out = local[idx]
    else:
        _, offset = local_shape_and_offset(table.shape, mesh,
                                           table.placements)
        rel = idx - offset[0]
        inside = (rel >= 0) & (rel < local.shape[0])
        out = local[rel.clamp(0, local.shape[0] - 1)] \
            .masked_fill(~inside[..., None], 0)
    return as_global(out, mesh, out_pl,
                     tuple(ids.shape) + tuple(table.shape[1:]))


def _along(t: torch.Tensor, dim: int, fn, size: int) -> torch.Tensor:
    """``fn`` of the DTensor ``t``'s local shard, ``dim`` gathered first, as
    a DTensor whose ``dim`` has ``size`` entries (differentiable: the
    backward runs on the local shards too)."""
    from torch.distributed.tensor import Replicate, Shard
    t = settle(t, [Replicate() if isinstance(pl, Shard) and pl.dim == dim
                   else pl for pl in t.placements])
    shape = list(t.shape)
    shape[dim] = size
    return as_global(fn(t.to_local()), t.device_mesh, t.placements, shape)


def pad_end(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with ``n`` zeros appended along ``dim``.  On a mesh the pad runs
    on local shards, ``dim`` gathered first (torch 2.11's sharding rule for
    a pad of a sharded DTensor fails)."""
    from torch.distributed.tensor import DTensor
    widths = (0, 0) * (t.dim() - 1 - dim) + (0, n)
    if not isinstance(t, DTensor):
        return torch.nn.functional.pad(t, widths)
    return _along(t, dim, lambda x: torch.nn.functional.pad(x, widths),
                  t.shape[dim] + n)


def cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum``.  On a mesh on local shards, ``dim`` gathered first
    (the backward flips, and torch 2.11 has no sharding rule for
    ``flip``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return torch.cumsum(t, dim=dim)
    return _along(t, dim, lambda x: torch.cumsum(x, dim=dim), t.shape[dim])


_ON_MESH = [0]          # depth of on_mesh scopes entered with a mesh


@contextlib.contextmanager
def on_mesh(mesh):
    """The scope the layers run in on a mesh: DTensor's
    ``implicit_replication``, under which a plain tensor that meets a
    DTensor in one op is taken as replicated on its mesh.  The plain tensors
    the layers make are the same on every rank: the aranges of the masks,
    RoPE's frequencies and positions, the fp32 floors, the zeros that
    start the online softmax, the loss's accumulator and the schedule's
    constants.  Nested scopes keep the outermost one's (DTensor's own
    switch is not nestable: leaving an inner one would turn it off).
    Without a mesh: no scope."""
    if mesh is None or _ON_MESH[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _ON_MESH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _ON_MESH[0] -= 1


# ---------------------------------------------------------------------------
# Products that work on DTensors
# ---------------------------------------------------------------------------

def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on DTensors, the product of the local shards.

    DTensor runs ``torch.einsum`` (and ``@``) as views and batched products
    of the flattened operands, and a view refuses to merge two sharded
    dimensions (an activation sharded on batch and, with sequence
    parallelism, on its sequence).  Here each mesh dimension of more than
    one rank shards one label, chosen to move the fewest elements (a shard
    of a replicated operand is free; a gather or an all-to-all is not), or
    none: every operand holding that label is sharded on it there, every
    other one replicated, and the output is sharded on the label, or
    ``Partial`` (a sum) where the label is contracted.  Then
    ``torch.einsum`` runs on the local shards; the gradient of an operand
    replicated where another is sharded is a partial sum there.  Plain
    tensors are taken as replicated; with no DTensor this is
    ``torch.einsum`` itself."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(t, DTensor) for t in operands):
        return torch.einsum(eq, *operands)
    return _einsum_on_mesh(eq, operands)


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` for a 2-D ``w``, through ``einsum`` on DTensors."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(a, DTensor) or isinstance(w, DTensor)):
        return a @ w
    lead = "abcdefgh"[:a.dim() - 1]
    return _einsum_on_mesh(f"{lead}y,yz->{lead}z", (a, w))


def _einsum_on_mesh(eq: str, operands: tuple) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = next(t.device_mesh for t in operands if isinstance(t, DTensor))
    ops = [replicated(t, mesh) for t in operands]
    size = {l: n for sub, t in zip(subs, ops) for l, n in zip(sub, t.shape)}
    targets = [list(t.placements) for t in ops]
    # an operand replicated where another one is sharded on a label it
    # lacks sees part of the product: its gradient is a partial sum there
    grads = [list(t.placements) for t in ops]
    out_pl: list = [Replicate()] * mesh.ndim
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:          # every layout is the whole tensor
            continue

        def want(label, k):
            if label and label in subs[k]:
                return Shard(subs[k].index(label))
            return Replicate()

        def cost(label):
            return sum(t.numel() for k, t in enumerate(ops)
                       if t.placements[i] != want(label, k)
                       and not isinstance(t.placements[i], Replicate))
        labels = [""] + sorted({subs[k][pl.dim] for k, t in enumerate(ops)
                                for pl in (t.placements[i],)
                                if isinstance(pl, Shard)})
        best = min(labels, key=lambda l: (cost(l), l not in out, l)) or None
        for k in range(len(ops)):
            targets[k][i] = grads[k][i] = want(best, k)
            if best is not None and best not in subs[k]:
                grads[k][i] = Partial()
        if best is not None:
            out_pl[i] = Shard(out.index(best)) if best in out else Partial()
    local = torch.einsum(eq, *(
        (t if tuple(pl) == tuple(t.placements) else t.redistribute(mesh, pl))
        .to_local(grad_placements=g)
        for t, pl, g in zip(ops, targets, grads)))
    return as_global(local, mesh, out_pl, [size[l] for l in out])
