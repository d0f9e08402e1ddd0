"""Symbolic tensors and the three STAGE distribution semantics.

The paper (§IV-C) defines exactly three tensor-level distribution types:

* **Duplicated**  — full copy on every device of an axis group,
* **Partition**   — disjointly sharded along one tensor dim,
* **PartialSum**  — every device holds a partial result (``@ 1/axis``).

A :class:`ShardSpec` composes these per *mesh axis*: each mesh axis is
either absent (Duplicated over it), partitions some tensor dim, or holds
a PartialSum.  This is the exact information the collective matcher
needs (paper Fig 5/6, Table IV).
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Optional, TYPE_CHECKING

import sympy as sp

from .symbolic import Expr, Env, prod, sym

if TYPE_CHECKING:  # pragma: no cover
    from .stg import Op

DTYPE_BYTES = {
    "bf16": 2, "fp16": 2, "fp32": 4, "fp64": 8,
    "int8": 1, "uint8": 1, "fp8": 1, "int32": 4, "int64": 8, "bool": 1,
}


@dataclass(frozen=True)
class MeshAxis:
    """A named parallelism axis (dp/tp/pp/ep/...) with its degree."""
    name: str
    size: int

    def __repr__(self) -> str:
        return f"{self.name}={self.size}"


@dataclass(frozen=True)
class ShardSpec:
    """Distribution of one tensor over the mesh.

    ``partition``: tuple of ``(dim_index, axis_name)`` pairs — tensor dim
    ``dim_index`` is disjointly sharded over mesh axis ``axis_name``.  A dim
    may be sharded by several axes (nested), and every axis appears at most
    once across the whole spec.

    ``partial``: mesh axes over which the tensor is a partial sum.

    Mesh axes appearing in neither are Duplicated.
    """
    partition: tuple[tuple[int, str], ...] = ()
    partial: tuple[str, ...] = ()

    def __post_init__(self):
        axes = [a for _, a in self.partition] + list(self.partial)
        if len(axes) != len(set(axes)):
            raise ValueError(f"mesh axis used twice in {self}")

    # -- queries ---------------------------------------------------------
    def axes_of_dim(self, dim: int) -> tuple[str, ...]:
        # hot query during distribution: lazily build a dim->axes table
        # (instance-cached via object.__setattr__; excluded from eq/hash,
        # which dataclasses derive from the declared fields only)
        by_dim = self.__dict__.get("_by_dim")
        if by_dim is None:
            by_dim = {}
            for d, a in self.partition:
                by_dim[d] = by_dim.get(d, ()) + (a,)
            object.__setattr__(self, "_by_dim", by_dim)
        return by_dim.get(dim, ())

    def dim_of_axis(self, axis: str) -> Optional[int]:
        for d, a in self.partition:
            if a == axis:
                return d
        return None

    def state_of_axis(self, axis: str) -> str:
        """'dup' | 'part' | 'partial' for one mesh axis."""
        if axis in self.partial:
            return "partial"
        if self.dim_of_axis(axis) is not None:
            return "part"
        return "dup"

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(a for _, a in self.partition) + tuple(self.partial)

    def is_replicated(self) -> bool:
        return not self.partition and not self.partial

    # -- constructors ----------------------------------------------------
    @staticmethod
    def make(partition: dict[int, tuple[str, ...]] | None = None,
             partial: tuple[str, ...] = ()) -> "ShardSpec":
        items: list[tuple[int, str]] = []
        for d in sorted((partition or {})):
            for a in (partition or {})[d]:
                items.append((d, a))
        return ShardSpec(tuple(items), tuple(partial))

    # -- transforms ------------------------------------------------------
    def drop_axis(self, axis: str) -> "ShardSpec":
        return ShardSpec(tuple((d, a) for d, a in self.partition if a != axis),
                         tuple(a for a in self.partial if a != axis))

    def with_partition(self, dim: int, axis: str) -> "ShardSpec":
        return ShardSpec(self.partition + ((dim, axis),), self.partial)

    def with_partial(self, axis: str) -> "ShardSpec":
        return ShardSpec(self.partition, self.partial + (axis,))

    def remap_dims(self, mapping: dict[int, int]) -> "ShardSpec":
        """Re-index tensor dims (for transpose/reshape-like ops).

        Dims absent from ``mapping`` drop their partitions (caller must have
        resolved them first)."""
        items = tuple((mapping[d], a) for d, a in self.partition if d in mapping)
        return ShardSpec(items, self.partial)

    def degree(self, mesh: dict[str, int]) -> int:
        """Total number of shards (product of partition-axis degrees)."""
        out = 1
        for _, a in self.partition:
            out *= mesh[a]
        return out

    def __repr__(self) -> str:
        if self.is_replicated():
            return "R"
        parts = [f"{d}/{a}" for d, a in self.partition]
        if self.partial:
            parts.append("@1/" + ",".join(self.partial))
        return "{" + " ".join(parts) + "}"


REPLICATED = ShardSpec()

# atomic under the GIL (concurrent sweep workers clone graphs in threads)
_uid = itertools.count(1)


def _next_uid() -> int:
    return next(_uid)


@dataclass(eq=False)
class STensor:
    """A symbolic tensor: logical (global) shape + distribution + metadata."""
    name: str
    shape: tuple[Expr, ...]
    dtype: str = "bf16"
    kind: str = "act"           # weight | act | grad | optstate | input | output | index
    spec: ShardSpec = REPLICATED
    producer: "Optional[Op]" = None
    uid: int = field(default_factory=_next_uid)

    def __post_init__(self):
        if not all(isinstance(d, sp.Basic) for d in self.shape):
            self.shape = tuple(sp.sympify(d) for d in self.shape)
        elif not isinstance(self.shape, tuple):
            self.shape = tuple(self.shape)

    # -- sizes -----------------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    def numel(self) -> sp.Expr:
        return prod(self.shape)

    def bytes(self) -> sp.Expr:
        return self.numel() * DTYPE_BYTES[self.dtype]

    def local_shape(self, mesh: dict[str, int]) -> tuple[Expr, ...]:
        """Per-device shard shape under ``mesh`` (axis name -> degree)."""
        dims = list(self.shape)
        for d, a in self.spec.partition:
            dims[d] = dims[d] / mesh[a]
        return tuple(dims)

    def local_bytes(self, mesh: dict[str, int]) -> sp.Expr:
        return prod(self.local_shape(mesh)) * DTYPE_BYTES[self.dtype]

    def with_spec(self, spec: ShardSpec) -> "STensor":
        return dataclasses.replace(self, spec=spec, uid=_next_uid())

    def clone(self) -> "STensor":
        """Structural copy with a fresh uid, sharing the immutable payload
        (sympy shape expressions, ShardSpec).  Bypasses ``__post_init__``
        so cloning never re-sympifies shapes; the producer link is dropped
        (:meth:`repro_torch.core.stg.Graph.clone` re-attaches it)."""
        t = object.__new__(STensor)
        t.name = self.name
        t.shape = self.shape
        t.dtype = self.dtype
        t.kind = self.kind
        t.spec = self.spec
        t.producer = None
        t.uid = _next_uid()
        roles = self.__dict__.get("roles")
        if roles is not None:
            t.roles = dict(roles)
        return t

    def like(self, name: str, spec: ShardSpec | None = None, kind: str | None = None) -> "STensor":
        return STensor(name, self.shape, self.dtype,
                       kind or self.kind, spec if spec is not None else self.spec)

    def pretty(self) -> str:
        dims = []
        for i, d in enumerate(self.shape):
            axes = self.spec.axes_of_dim(i)
            dims.append(f"{d}" + ("/" + "/".join(axes) if axes else ""))
        s = f"{self.name}[{', '.join(dims)}"
        if self.spec.partial:
            s += " @ 1/" + ",".join(self.spec.partial)
        return s + "]"

    def __repr__(self) -> str:
        return self.pretty()
