"""Symbolic Tensor Graph (STG): ops, graph, shape propagation, autodiff.

The STG is the paper's IR (§IV-C): nodes are symbolic operations (einsum
first and foremost — "STAGE adopts *einsum* to express all tensor
multiplications"), edges are symbolic tensors carrying distribution
annotations.  A single graph describes the whole (un-replicated) model;
the distributor (distribute.py) + matcher (matcher.py) then turn it into
a distributed graph, and instantiate.py grounds symbols to numbers.

Training graphs are produced by building the forward graph from module
templates and calling :func:`backward` — gradient ops are generated by
per-op VJP rules, so backward GeMM/elementwise counts match what a real
framework traces (paper Table VI counts include backward).
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

import sympy as sp

from .symbolic import Env, Expr, prod, sym
from .tensor import DTYPE_BYTES, REPLICATED, MeshAxis, STensor, ShardSpec

# Operator categories, following the paper's validation breakdown (§V-C):
# GeMM / Attn / ElementWise / Others (+ Comm for collectives).
CAT_GEMM = "GeMM"
CAT_ATTN = "Attn"
CAT_EW = "ElementWise"
CAT_OTHER = "Others"
CAT_COMM = "Comm"

# itertools.count: atomic under the GIL, so graph clones are safe from
# concurrent sweep workers (a list-increment counter would race)
_op_uid = itertools.count(1)


def _next_op_uid() -> int:
    return next(_op_uid)


@dataclass(eq=False)
class Op:
    """Base symbolic operation."""
    name: str
    ins: list[STensor]
    outs: list[STensor]
    category: str = CAT_OTHER
    phase: str = "fwd"                 # fwd | bwd | opt
    tags: dict = field(default_factory=dict)   # e.g. {"layer": 3, "module": "mha"}
    uid: int = field(default_factory=_next_op_uid)

    @property
    def out(self) -> STensor:
        return self.outs[0]

    @property
    def kind(self) -> str:
        return type(self).__name__

    # ---- costs (per device, under the given mesh) -----------------------
    def flops(self, env: Env, mesh: dict[str, int]) -> float:
        return 0.0

    def bytes_accessed(self, env: Env, mesh: dict[str, int]) -> float:
        total = 0.0
        for t in list(self.ins) + list(self.outs):
            if t.kind == "index":
                continue
            total += (env.fevaluate(prod(t.local_shape(mesh)))) * DTYPE_BYTES[t.dtype]
        return total

    # ---- autodiff --------------------------------------------------------
    def vjp(self, b: "GraphBuilder", g: STensor, needs: list[bool]) -> list[Optional[STensor]]:
        raise NotImplementedError(f"no vjp for {self.kind}")

    def __repr__(self) -> str:
        return (f"{self.kind}({self.name}: "
                f"{', '.join(t.pretty() for t in self.ins)} -> "
                f"{', '.join(t.pretty() for t in self.outs)})")


def _letter_dims(spec_in: Sequence[str], spec_out: str,
                 ins: Sequence[STensor], out_shape_hint: Optional[dict] = None) -> dict[str, Expr]:
    dims: dict[str, Expr] = dict(out_shape_hint or {})
    for letters, t in zip(spec_in, ins):
        if len(letters) != t.rank:
            raise ValueError(f"einsum spec {letters} vs rank-{t.rank} tensor {t}")
        for ch, d in zip(letters, t.shape):
            if ch in dims:
                if dims[ch] != d and sp.simplify(dims[ch] - d) != 0:
                    raise ValueError(f"dim mismatch for '{ch}': {dims[ch]} vs {d}")
            else:
                dims[ch] = d
    return dims


class Einsum(Op):
    """General tensor contraction ``out = einsum[spec](ins...)`` (paper §IV-C)."""

    def __init__(self, name: str, spec: str, ins: list[STensor], *,
                 out_name: Optional[str] = None, dtype: Optional[str] = None,
                 category: str = CAT_GEMM, phase: str = "fwd", tags=None,
                 out_shape_hint: Optional[dict] = None):
        lhs, rhs = spec.replace(" ", "").split("->")
        in_specs = lhs.split(",")
        dims = _letter_dims(in_specs, rhs, ins, out_shape_hint)
        out_shape = tuple(dims[ch] for ch in rhs)
        out = STensor(out_name or name, out_shape, dtype or ins[0].dtype, "act")
        super().__init__(name, list(ins), [out], category=category,
                         phase=phase, tags=dict(tags or {}))
        self.spec = spec.replace(" ", "")
        self.in_specs = in_specs
        self.out_spec = rhs
        self._dims = dims
        out.producer = self

    @property
    def contraction_letters(self) -> list[str]:
        seen = set("".join(self.in_specs))
        return sorted(ch for ch in seen if ch not in self.out_spec)

    def letter_shard_axes(self, letter: str) -> tuple[str, ...]:
        """Mesh axes sharding ``letter`` in any operand/output."""
        axes: list[str] = []
        for letters, t in list(zip(self.in_specs, self.ins)) + [(self.out_spec, self.out)]:
            idx = letters.find(letter)
            if idx >= 0:
                for a in t.spec.axes_of_dim(idx):
                    if a not in axes:
                        axes.append(a)
        return tuple(axes)

    def flops(self, env: Env, mesh: dict[str, int]) -> float:
        total = 2.0
        for letter in sorted(set("".join(self.in_specs)) | set(self.out_spec)):
            deg = 1
            for a in self.letter_shard_axes(letter):
                deg *= mesh[a]
            total *= env.fevaluate(self._dims[letter]) / deg
        return total

    def vjp(self, b: "GraphBuilder", g: STensor, needs: list[bool]) -> list[Optional[STensor]]:
        grads: list[Optional[STensor]] = []
        for i, (letters, t) in enumerate(zip(self.in_specs, self.ins)):
            if not needs[i]:
                grads.append(None)
                continue
            others = [(ls, x) for j, (ls, x) in enumerate(zip(self.in_specs, self.ins)) if j != i]
            in_letters = [self.out_spec] + [ls for ls, _ in others]
            operands = [g] + [x for _, x in others]
            spec = ",".join(in_letters) + "->" + letters
            grads.append(b.einsum(f"d{t.name}", spec, operands,
                                  category=self.category, phase="bwd",
                                  tags=self.tags,
                                  out_shape_hint={ch: d for ch, d in zip(letters, t.shape)}))
        return grads


class Map(Op):
    """Elementwise op with numpy broadcasting (activation fns, add, mul...)."""

    def __init__(self, name: str, fn: str, ins: list[STensor], *,
                 flop_per_elem: float = 1.0, out_dtype: Optional[str] = None,
                 category: str = CAT_EW, phase: str = "fwd", tags=None,
                 linear: bool = False):
        out_shape = _broadcast_shapes([t.shape for t in ins])
        out = STensor(name, out_shape, out_dtype or ins[0].dtype, "act")
        super().__init__(name, list(ins), [out], category=category,
                         phase=phase, tags=dict(tags or {}))
        self.fn = fn
        self.flop_per_elem = flop_per_elem
        self.linear = linear
        out.producer = self

    def flops(self, env: Env, mesh: dict[str, int]) -> float:
        return self.flop_per_elem * (env.fevaluate(prod(self.out.local_shape(mesh))))

    def vjp(self, b, g, needs):
        grads: list[Optional[STensor]] = []
        for i, t in enumerate(self.ins):
            if not needs[i]:
                grads.append(None)
                continue
            gi = b.map(f"d{t.name}", f"grad_{self.fn}", [g] + list(self.ins),
                       flop_per_elem=max(1.0, self.flop_per_elem),
                       phase="bwd", tags=self.tags)
            if tuple(t.shape) != tuple(gi.shape):
                # reduce broadcasted dims back
                padded = _padded(t.shape, gi.shape)
                red = [d for d in range(len(gi.shape))
                       if gi.shape[d] != padded[d]]
                gi = b.reduce(f"d{t.name}_r", gi, dims=tuple(red), phase="bwd", tags=self.tags,
                              out_shape=t.shape)
            grads.append(gi)
        return grads


def _padded(shape, ref):
    pad = (sp.Integer(1),) * (len(ref) - len(shape))
    return pad + tuple(shape)


def _broadcast_shapes(shapes: list[tuple]) -> tuple:
    one = sp.Integer(1)
    rank = max(len(s) for s in shapes)
    out = []
    for d in range(rank):
        dims = [_padded(s, [None] * rank)[d] for s in shapes]
        best = one
        for x in dims:
            if x != one:
                if best != one and best != x:
                    raise ValueError(f"broadcast mismatch {dims}")
                best = x
        out.append(best)
    return tuple(out)


class Reduce(Op):
    """Reduction (sum/max/mean) over ``dims``."""

    def __init__(self, name: str, fn: str, x: STensor, dims: tuple[int, ...], *,
                 out_shape: Optional[tuple] = None, keepdims: bool = False,
                 category: str = CAT_EW, phase: str = "fwd", tags=None):
        if out_shape is None:
            out_shape = tuple(sp.Integer(1) if i in dims else d
                              for i, d in enumerate(x.shape)) if keepdims else \
                        tuple(d for i, d in enumerate(x.shape) if i not in dims)
        out = STensor(name, out_shape, x.dtype, "act")
        super().__init__(name, [x], [out], category=category, phase=phase, tags=dict(tags or {}))
        self.fn = fn
        self.dims = dims
        self.keepdims = keepdims
        out.producer = self

    def flops(self, env, mesh):
        return (env.fevaluate(prod(self.ins[0].local_shape(mesh))))

    def vjp(self, b, g, needs):
        if not needs[0]:
            return [None]
        return [b.map(f"d{self.ins[0].name}", f"bcast_{self.fn}", [g, self.ins[0]],
                      phase="bwd", tags=self.tags)]


class Softmax(Op):
    def __init__(self, name: str, x: STensor, *, dim: int = -1,
                 category: str = CAT_EW, phase: str = "fwd", tags=None):
        out = STensor(name, x.shape, x.dtype, "act")
        super().__init__(name, [x], [out], category=category, phase=phase, tags=dict(tags or {}))
        self.dim = dim % len(x.shape)
        out.producer = self

    def flops(self, env, mesh):
        return 5.0 * (env.fevaluate(prod(self.out.local_shape(mesh))))

    def vjp(self, b, g, needs):
        return [b.map(f"d{self.ins[0].name}", "grad_softmax", [g, self.out],
                      flop_per_elem=4.0, phase="bwd", tags=self.tags)]


class Norm(Op):
    """RMSNorm / LayerNorm over the last dim, with a weight vector."""

    def __init__(self, name: str, kind_: str, x: STensor, w: STensor, *,
                 phase: str = "fwd", tags=None):
        out = STensor(name, x.shape, x.dtype, "act")
        super().__init__(name, [x, w], [out], category=CAT_EW, phase=phase, tags=dict(tags or {}))
        self.norm_kind = kind_
        out.producer = self

    def flops(self, env, mesh):
        return 4.0 * (env.fevaluate(prod(self.out.local_shape(mesh))))

    def vjp(self, b, g, needs):
        gx = b.map(f"d{self.ins[0].name}", f"grad_{self.norm_kind}",
                   [g, self.ins[0], self.ins[1]], flop_per_elem=6.0,
                   phase="bwd", tags=self.tags) if needs[0] else None
        gw = None
        if needs[1]:
            gw_full = b.map(f"d{self.ins[1].name}_e", "mul", [g, self.ins[0]],
                            phase="bwd", tags=self.tags)
            red = tuple(range(len(g.shape) - 1))
            gw = b.reduce(f"d{self.ins[1].name}", gw_full, dims=red,
                          phase="bwd", tags=self.tags)
        return [gx, gw]


class PScan(Op):
    """Associative (linear-recurrence) scan over the sequence dim.

    Models the SSM/RWKV sequence mix (paper Table X ``pscan[s]``):
    ``h[t] = a[t] * h[t-1] + x[t]`` along dim ``seq_dim``.  FLOPs follow
    the paper's linear-form accounting (2 ops per element per step).
    """

    def __init__(self, name: str, a: STensor, x: STensor, *, seq_dim: int,
                 phase: str = "fwd", tags=None):
        out = STensor(name, x.shape, x.dtype, "act")
        super().__init__(name, [a, x], [out], category=CAT_ATTN, phase=phase, tags=dict(tags or {}))
        self.seq_dim = seq_dim
        out.producer = self

    def flops(self, env, mesh):
        return 2.0 * (env.fevaluate(prod(self.out.local_shape(mesh))))

    def vjp(self, b, g, needs):
        # reverse-direction scan + elementwise
        gh = b.pscan(f"d{self.name}_rev", self.ins[0], g, seq_dim=self.seq_dim,
                     phase="bwd", tags=self.tags)
        ga = b.map(f"d{self.ins[0].name}", "mul_shift", [gh, self.out],
                   phase="bwd", tags=self.tags) if needs[0] else None
        gx = gh if needs[1] else None
        return [ga, gx]


class Embed(Op):
    """Embedding gather: ``out[b,s,:] = table[ids[b,s],:]``."""

    def __init__(self, name: str, table: STensor, ids: STensor, *,
                 phase: str = "fwd", tags=None):
        out_shape = tuple(ids.shape) + (table.shape[-1],)
        out = STensor(name, out_shape, table.dtype, "act")
        super().__init__(name, [table, ids], [out], category=CAT_OTHER,
                         phase=phase, tags=dict(tags or {}))
        out.producer = self

    def vjp(self, b, g, needs):
        gt = None
        if needs[0]:
            op = ScatterAdd(b._unique(f"d{self.ins[0].name}"), g, self.ins[1],
                            self.ins[0].shape, phase="bwd", tags=self.tags)
            op.table = self.ins[0]
            b.add_op(op)
            gt = op.out
        return [gt, None]


class ScatterAdd(Op):
    """Embedding-table gradient: scatter-add token grads into [V, H].

    Each device contributes from its local batch/sequence shard, so the
    result is a PartialSum over those axes (the DP grad-sync AllReduce
    for the embedding emerges from this in the matcher)."""

    def __init__(self, name: str, g: STensor, ids: STensor, table_shape, *,
                 phase="bwd", tags=None):
        out = STensor(name, tuple(table_shape), g.dtype, "act")
        super().__init__(name, [g, ids], [out], category=CAT_EW,
                         phase=phase, tags=dict(tags or {}))
        out.producer = self

    def flops(self, env, mesh):
        return (env.fevaluate(prod(self.ins[0].local_shape(mesh))))


class Transpose(Op):
    def __init__(self, name: str, x: STensor, perm: tuple[int, ...], *,
                 phase: str = "fwd", tags=None):
        out = STensor(name, tuple(x.shape[p] for p in perm), x.dtype, "act")
        super().__init__(name, [x], [out], category=CAT_OTHER, phase=phase, tags=dict(tags or {}))
        self.perm = perm
        out.producer = self

    def vjp(self, b, g, needs):
        inv = tuple(self.perm.index(i) for i in range(len(self.perm)))
        return [b.transpose(f"d{self.ins[0].name}", g, inv, phase="bwd", tags=self.tags)]


class Reshape(Op):
    """Reshape with an explicit old->new dim mapping for shard propagation."""

    def __init__(self, name: str, x: STensor, new_shape: tuple, dim_map: dict[int, int], *,
                 phase: str = "fwd", tags=None):
        out = STensor(name, tuple(new_shape), x.dtype, "act")
        super().__init__(name, [x], [out], category=CAT_OTHER, phase=phase, tags=dict(tags or {}))
        self.dim_map = dict(dim_map)
        out.producer = self

    def vjp(self, b, g, needs):
        inv = {v: k for k, v in self.dim_map.items()}
        return [b.reshape(f"d{self.ins[0].name}", g, self.ins[0].shape, inv,
                          phase="bwd", tags=self.tags)]


class Concat(Op):
    def __init__(self, name: str, xs: list[STensor], dim: int, *, phase="fwd", tags=None):
        shape = list(xs[0].shape)
        shape[dim] = sum((x.shape[dim] for x in xs), sp.Integer(0))
        out = STensor(name, tuple(shape), xs[0].dtype, "act")
        super().__init__(name, list(xs), [out], category=CAT_OTHER, phase=phase, tags=dict(tags or {}))
        self.dim = dim
        out.producer = self

    def vjp(self, b, g, needs):
        return [b.slice_like(f"d{x.name}", g, x.shape, phase="bwd", tags=self.tags)
                if n else None for x, n in zip(self.ins, needs)]


class SliceLike(Op):
    """Local slice (the paper's Slice* — single-machine, no comm)."""

    def __init__(self, name: str, x: STensor, out_shape: tuple, *, phase="fwd", tags=None):
        out = STensor(name, tuple(out_shape), x.dtype, "act")
        super().__init__(name, [x], [out], category=CAT_OTHER, phase=phase, tags=dict(tags or {}))
        out.producer = self

    def vjp(self, b, g, needs):
        # pad the gradient back to the input's shape
        return [b.slice_like(f"d{self.ins[0].name}", g, self.ins[0].shape,
                             phase="bwd", tags=self.tags)]


class TopK(Op):
    """MoE router top-k: returns (weights, indices) over the experts dim."""

    def __init__(self, name: str, scores: STensor, k: Expr, *, phase="fwd", tags=None):
        shape = tuple(scores.shape[:-1]) + (sp.sympify(k),)
        vals = STensor(name + "_w", shape, scores.dtype, "act")
        idx = STensor(name + "_i", shape, "int32", "index")
        super().__init__(name, [scores], [vals, idx], category=CAT_OTHER,
                         phase=phase, tags=dict(tags or {}))
        vals.producer = self
        idx.producer = self

    def flops(self, env, mesh):
        return (env.fevaluate(prod(self.ins[0].local_shape(mesh))))

    def vjp(self, b, g, needs):
        if not needs[0]:
            return [None]
        # scatter the k selected grads back into the experts dim
        return [b.slice_like(f"d{self.ins[0].name}", g, self.ins[0].shape,
                             phase="bwd", tags=self.tags)]


class Dispatch(Op):
    """MoE dispatch: tokens [B,S,H] + idx -> [E, C, H] (C = B*S*K/E capacity).

    Shape-changing data movement; when the input's token shards (dp axis) and
    the output's expert shards (ep axis) live on the same mesh axis, the
    matcher resolves the mismatch as an AllToAll — the EP pattern of
    paper Table IV.
    """

    def __init__(self, name: str, x: STensor, idx: STensor, e: Expr, cap: Expr, *,
                 combine: bool = False, out_shape: Optional[tuple] = None,
                 phase="fwd", tags=None):
        if out_shape is None:
            out_shape = (sp.sympify(e), sp.sympify(cap), x.shape[-1])
        out = STensor(name, tuple(out_shape), x.dtype, "act")
        super().__init__(name, [x, idx], [out], category=CAT_OTHER,
                         phase=phase, tags=dict(tags or {}))
        self.combine = combine
        out.producer = self

    def vjp(self, b, g, needs):
        gx = None
        if needs[0]:
            gx = b.dispatch(f"d{self.ins[0].name}", g, self.ins[1],
                            out_shape=self.ins[0].shape, combine=not self.combine,
                            phase="bwd", tags=self.tags)
        return [gx, None]


class CrossEntropy(Op):
    """Token-level CE loss vs integer labels -> scalar-ish [B,S] loss."""

    def __init__(self, name: str, logits: STensor, labels: STensor, *, phase="fwd", tags=None):
        out = STensor(name, tuple(logits.shape[:-1]), "fp32", "act")
        super().__init__(name, [logits, labels], [out], category=CAT_EW,
                         phase=phase, tags=dict(tags or {}))
        out.producer = self

    def flops(self, env, mesh):
        return 5.0 * (env.fevaluate(prod(self.ins[0].local_shape(mesh))))

    def vjp(self, b, g, needs):
        if not needs[0]:
            return [None, None]
        g3 = b.reshape(f"d{self.name}_exp", g, tuple(g.shape) + (sp.Integer(1),),
                       {i: i for i in range(len(g.shape))},
                       phase="bwd", tags=self.tags)
        gl = b.map(f"d{self.ins[0].name}", "grad_ce", [g3, self.ins[0]],
                   flop_per_elem=3.0, phase="bwd", tags=self.tags)
        return [gl, None]


class Update(Op):
    """Optimizer update (AdamW-style): param', m', v' from (param, grad)."""

    def __init__(self, name: str, param: STensor, grad: STensor, *, tags=None):
        out = STensor(name, param.shape, param.dtype, "weight", param.spec)
        m = STensor(name + "_m", param.shape, "fp32", "optstate", param.spec)
        v = STensor(name + "_v", param.shape, "fp32", "optstate", param.spec)
        super().__init__(name, [param, grad], [out, m, v], category=CAT_EW,
                         phase="opt", tags=dict(tags or {}))
        for t in (out, m, v):
            t.producer = self

    def flops(self, env, mesh):
        return 12.0 * (env.fevaluate(prod(self.out.local_shape(mesh))))


# --------------------------------------------------------------------------
# Collective communication ops (inserted by the matcher; §IV-D)
# --------------------------------------------------------------------------

COLL_KINDS = ("AllReduce", "AllGather", "ReduceScatter", "AllToAll",
              "Broadcast", "Gather", "Scatter", "Reduce", "Send", "Recv")


class Comm(Op):
    def __init__(self, name: str, coll: str, x: STensor, out: STensor,
                 axis: str, *, dim: Optional[int] = None,
                 dim_dst: Optional[int] = None, phase="fwd", tags=None):
        assert coll in COLL_KINDS, coll
        super().__init__(name, [x], [out], category=CAT_COMM, phase=phase,
                         tags=dict(tags or {}))
        self.coll = coll
        self.axis = axis
        self.dim = dim
        self.dim_dst = dim_dst
        out.producer = self

    def group_size(self, mesh: dict[str, int]) -> int:
        return mesh[self.axis]

    def comm_bytes(self, env: Env, mesh: dict[str, int]) -> float:
        """Per-device message volume (bytes), NCCL/Kineto convention:
        per-rank buffer for AllGather/ReduceScatter/AllToAll (full/g),
        full tensor for AllReduce/Broadcast/Reduce."""
        full = (env.fevaluate(self.out.bytes() if self.coll == "AllGather"
                                  else self.ins[0].bytes()))
        n = self.group_size(mesh)
        other_deg = 1
        ref = self.out if self.coll == "AllGather" else self.ins[0]
        for _, a in ref.spec.partition:
            if a != self.axis:
                other_deg *= mesh[a]
        full /= other_deg
        if self.coll in ("AllReduce", "Broadcast", "Reduce", "Gather",
                         "Scatter"):
            return full
        # AllGather / ReduceScatter / AllToAll: per-rank shard
        return full / n

    def wire_bytes(self, env: Env, mesh: dict[str, int]) -> float:
        """Bytes actually crossing links per device (ring algorithm terms)."""
        v = self.comm_bytes(env, mesh)
        n = self.group_size(mesh)
        if n <= 1:
            return 0.0
        if self.coll in ("AllGather", "ReduceScatter", "Gather", "Scatter",
                         "Broadcast", "Reduce"):
            return v * (n - 1) / n
        if self.coll == "AllReduce":
            return v * 2 * (n - 1) / n
        if self.coll == "AllToAll":
            return v * (n - 1) / n
        return v  # Send / Recv


class SendRecv(Op):
    """Cross-stage point-to-point (graph-level distribution, §IV-D3)."""

    def __init__(self, name: str, x: STensor, src_stage: int, dst_stage: int, *,
                 phase="fwd", tags=None):
        out = STensor(name, x.shape, x.dtype, "act", x.spec)
        super().__init__(name, [x], [out], category=CAT_COMM, phase=phase,
                         tags=dict(tags or {}))
        self.src_stage = src_stage
        self.dst_stage = dst_stage
        out.producer = self

    def comm_bytes(self, env: Env, mesh: dict[str, int]) -> float:
        return (env.fevaluate(prod(self.ins[0].local_shape(mesh)))) \
            * DTYPE_BYTES[self.ins[0].dtype]

    wire_bytes = comm_bytes


# --------------------------------------------------------------------------
# Graph + builder
# --------------------------------------------------------------------------

@dataclass
class Graph:
    ops: list[Op] = field(default_factory=list)
    inputs: list[STensor] = field(default_factory=list)
    weights: list[STensor] = field(default_factory=list)
    outputs: list[STensor] = field(default_factory=list)
    grads: dict[int, STensor] = field(default_factory=dict)   # weight uid -> grad

    def tensors(self) -> list[STensor]:
        seen: dict[int, STensor] = {}
        for t in self.inputs + self.weights:
            seen[t.uid] = t
        for op in self.ops:
            for t in list(op.ins) + list(op.outs):
                seen.setdefault(t.uid, t)
        return list(seen.values())

    def consumers(self) -> dict[int, list[Op]]:
        cons: dict[int, list[Op]] = {}
        for op in self.ops:
            for t in op.ins:
                cons.setdefault(t.uid, []).append(op)
        return cons

    def validate(self) -> None:
        produced = {t.uid for t in self.inputs + self.weights}
        for op in self.ops:
            for t in op.ins:
                if t.uid not in produced:
                    raise ValueError(f"op {op.name} consumes unproduced tensor {t.name}")
            for t in op.outs:
                produced.add(t.uid)

    def clone(self) -> "Graph":
        """Structural copy: fresh STensor/Op identities (new uids), shared
        immutable payloads (sympy shapes, ShardSpecs, einsum specs).

        distribute/apply_pipeline mutate the graph in place, so reusing an
        assembled graph across parallel configs requires a copy; cloning is
        cheaper than re-running template assembly + autodiff + validation,
        which is what lets :class:`repro_torch.api.Scenario` cache one symbolic
        graph per (spec, mode) and hand every config its own mutable copy."""
        tmap: dict[int, STensor] = {}

        def ct(t: Optional[STensor]) -> Optional[STensor]:
            if t is None:
                return None
            nt = tmap.get(t.uid)
            if nt is None:
                nt = t.clone()
                tmap[t.uid] = nt
            return nt

        g = Graph(inputs=[ct(t) for t in self.inputs],
                  weights=[ct(t) for t in self.weights])
        for op in self.ops:
            # bare-metal copy.copy: same __dict__ snapshot without the
            # copymodule dispatch (clone is the per-point hot path)
            cls = type(op)
            nop = cls.__new__(cls)
            nop.__dict__.update(op.__dict__)
            nop.uid = _next_op_uid()
            nop.ins = [ct(t) for t in op.ins]
            nop.outs = [ct(t) for t in op.outs]
            nop.tags = dict(op.tags)
            table = getattr(op, "table", None)     # ScatterAdd back-reference
            if table is not None:
                nop.table = ct(table)
            for t in nop.outs:
                t.producer = nop
            g.ops.append(nop)
        g.outputs = [ct(t) for t in self.outputs]
        g.grads = {tmap[w_uid].uid: ct(gr) for w_uid, gr in self.grads.items()
                   if w_uid in tmap}
        return g


class GraphBuilder:
    """Convenience layer for constructing STGs (used by module templates)."""

    def __init__(self, graph: Optional[Graph] = None):
        self.graph = graph or Graph()
        self._names: dict[str, int] = {}

    def clone(self) -> "GraphBuilder":
        """Independent builder over a :meth:`Graph.clone` copy (name-dedup
        state carried over so further construction stays collision-free)."""
        b = GraphBuilder(self.graph.clone())
        b._names = dict(self._names)
        return b

    def _unique(self, name: str) -> str:
        n = self._names.get(name, 0)
        self._names[name] = n + 1
        return name if n == 0 else f"{name}.{n}"

    def add_op(self, op: Op) -> Op:
        self.graph.ops.append(op)
        return op

    # -- roots ------------------------------------------------------------
    def input(self, name: str, shape, dtype="bf16", kind="input") -> STensor:
        t = STensor(self._unique(name), tuple(shape), dtype, kind)
        self.graph.inputs.append(t)
        return t

    def weight(self, name: str, shape, dtype="bf16") -> STensor:
        t = STensor(self._unique(name), tuple(shape), dtype, "weight")
        self.graph.weights.append(t)
        return t

    # -- ops ----------------------------------------------------------------
    def einsum(self, name, spec, ins, *, category=CAT_GEMM, phase="fwd",
               tags=None, out_shape_hint=None) -> STensor:
        op = Einsum(self._unique(name), spec, list(ins), category=category,
                    phase=phase, tags=tags, out_shape_hint=out_shape_hint)
        return self.add_op(op).out

    def map(self, name, fn, ins, *, flop_per_elem=1.0, category=CAT_EW,
            phase="fwd", tags=None, linear=False, out_dtype=None) -> STensor:
        return self.add_op(Map(self._unique(name), fn, list(ins),
                               flop_per_elem=flop_per_elem, category=category,
                               phase=phase, tags=tags, linear=linear,
                               out_dtype=out_dtype)).out

    def reduce(self, name, x, *, dims, fn="sum", keepdims=False, phase="fwd",
               tags=None, out_shape=None) -> STensor:
        return self.add_op(Reduce(self._unique(name), fn, x, tuple(dims),
                                  keepdims=keepdims, out_shape=out_shape,
                                  phase=phase, tags=tags)).out

    def softmax(self, name, x, *, dim=-1, category=CAT_EW, phase="fwd", tags=None) -> STensor:
        return self.add_op(Softmax(self._unique(name), x, dim=dim,
                                   category=category, phase=phase, tags=tags)).out

    def norm(self, name, kind_, x, w, *, phase="fwd", tags=None) -> STensor:
        return self.add_op(Norm(self._unique(name), kind_, x, w, phase=phase, tags=tags)).out

    def pscan(self, name, a, x, *, seq_dim, phase="fwd", tags=None) -> STensor:
        return self.add_op(PScan(self._unique(name), a, x, seq_dim=seq_dim,
                                 phase=phase, tags=tags)).out

    def embed(self, name, table, ids, *, phase="fwd", tags=None) -> STensor:
        return self.add_op(Embed(self._unique(name), table, ids, phase=phase, tags=tags)).out

    def transpose(self, name, x, perm, *, phase="fwd", tags=None) -> STensor:
        return self.add_op(Transpose(self._unique(name), x, tuple(perm),
                                     phase=phase, tags=tags)).out

    def reshape(self, name, x, new_shape, dim_map, *, phase="fwd", tags=None) -> STensor:
        return self.add_op(Reshape(self._unique(name), x, tuple(new_shape),
                                   dim_map, phase=phase, tags=tags)).out

    def concat(self, name, xs, dim, *, phase="fwd", tags=None) -> STensor:
        return self.add_op(Concat(self._unique(name), list(xs), dim,
                                  phase=phase, tags=tags)).out

    def slice_like(self, name, x, out_shape, *, phase="fwd", tags=None) -> STensor:
        return self.add_op(SliceLike(self._unique(name), x, tuple(out_shape),
                                     phase=phase, tags=tags)).out

    def topk(self, name, scores, k, *, phase="fwd", tags=None) -> tuple[STensor, STensor]:
        op = self.add_op(TopK(self._unique(name), scores, k, phase=phase, tags=tags))
        return op.outs[0], op.outs[1]

    def dispatch(self, name, x, idx, *, e=None, cap=None, out_shape=None,
                 combine=False, phase="fwd", tags=None) -> STensor:
        return self.add_op(Dispatch(self._unique(name), x, idx, e, cap,
                                    combine=combine, out_shape=out_shape,
                                    phase=phase, tags=tags)).out

    def cross_entropy(self, name, logits, labels, *, phase="fwd", tags=None) -> STensor:
        return self.add_op(CrossEntropy(self._unique(name), logits, labels,
                                        phase=phase, tags=tags)).out


# --------------------------------------------------------------------------
# Autodiff (builds backward ops into the same graph)
# --------------------------------------------------------------------------

def backward(b: GraphBuilder, loss: STensor, wrt: Optional[list[STensor]] = None) -> dict[int, STensor]:
    """Reverse-mode: append grad ops for ``loss`` w.r.t. weights (+ ``wrt``).

    Returns ``{tensor uid -> grad tensor}`` for all weights reached.
    """
    g = b.graph
    wrt = list(wrt or [])
    want = {t.uid for t in g.weights} | {t.uid for t in wrt}

    # which tensors need grads: weights + anything on a path weight->loss
    needs_grad: set[int] = set(want)
    for op in g.ops:                      # ops are in topo order by construction
        if any(t.uid in needs_grad for t in op.ins):
            for t in op.outs:
                if t.kind != "index":
                    needs_grad.add(t.uid)

    grad_of: dict[int, STensor] = {}
    ones = STensor("dloss", loss.shape, "bf16", "act")
    # seed: unit gradient (no op needed; treat as input)
    g.inputs.append(ones)
    grad_of[loss.uid] = ones

    for op in reversed(list(g.ops)):
        if op.phase != "fwd":
            continue
        gouts = [grad_of.get(t.uid) for t in op.outs]
        if all(x is None for x in gouts):
            continue
        gout = next(x for x in gouts if x is not None)
        needs = [(t.uid in want)
                 or (t.uid in needs_grad and t.kind not in ("index", "input"))
                 for t in op.ins]
        if not any(needs):
            continue
        gins = op.vjp(b, gout, needs)
        for t, gi in zip(op.ins, gins):
            if gi is None:
                continue
            if t.uid in grad_of:  # accumulate
                grad_of[t.uid] = b.map(f"acc_d{t.name}", "add",
                                       [grad_of[t.uid], gi], phase="bwd",
                                       linear=True, tags=op.tags)
            else:
                grad_of[t.uid] = gi

    for w in g.weights:
        if w.uid in grad_of:
            grad_of[w.uid].kind = "grad"
            g.grads[w.uid] = grad_of[w.uid]
    return grad_of


def add_optimizer(b: GraphBuilder) -> None:
    """Append AdamW-style Update ops for every weight with a grad."""
    g = b.graph
    for w in g.weights:
        gr = g.grads.get(w.uid)
        if gr is not None:
            tags = dict(getattr(gr.producer, "tags", None) or {})
            tags["module"] = "opt"
            b.add_op(Update(f"upd_{w.name}", w, gr, tags=tags))
