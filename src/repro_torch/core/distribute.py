"""Tensor-level workload distributor (paper §IV-D1).

The distributor walks the (forward+backward+optimizer) STG in topological
order and, for every op, derives the distribution each input *must* have
for the op to execute locally (Megatron-style alignment: activations
follow the fixed weight shardings; elementwise ops follow their first
operand; norms require the normalized dim unsharded; scans require the
scan dim unsharded).  Wherever the producer's distribution disagrees,
:func:`repro_torch.core.matcher.insert_comms` splices in the matched
collective chain — this is how *all* communication in the generated
workload arises (Fig 5: "tensor distribution mismatch").

Weight storage specs come from *roles* attached by the module templates
(``tp_col`` / ``tp_row`` / ``vocab`` / ``expert`` / ``kv_heads``), mapped
onto mesh axes by the :class:`ParallelCfg` — Table III's strategy
catalogue.  FSDP(ZeRO-3) adds a dp-axis shard on weight storage (the
matcher then emits the pre-use AllGather and grad ReduceScatter that
define FSDP); ZeRO-1 shards only the optimizer update (ReduceScatter
grads + AllGather fresh params).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Optional

import sympy as sp

from .matcher import InfeasibleConfigError, _canon, insert_comms
from .schedules import SCHEDULES, build_schedule
from .stg import (CAT_COMM, Comm, CrossEntropy, Dispatch, Einsum, Embed, Graph,
                  GraphBuilder, Map, Norm, Op, PScan, Reduce, Reshape,
                  ScatterAdd, Softmax, SliceLike, TopK, Transpose, Update)
from .symbolic import Env
from .tensor import REPLICATED, ShardSpec, STensor


@dataclass
class ParallelCfg:
    """A point in the parallelization design space (paper §II-B strategies)."""
    axes: dict[str, int] = field(default_factory=dict)   # mesh: name -> degree
    dp_axis: Optional[str] = None      # data parallel
    tp_axis: Optional[str] = None      # tensor parallel (Megatron col/row)
    sp: bool = False                   # sequence parallel (with TP)
    cp_axis: Optional[str] = None      # context parallel (shard S)
    ep_axis: Optional[str] = None      # expert parallel (usually == dp_axis)
    fsdp: bool = False                 # ZeRO-3 weight sharding over dp_axis
    zero1: bool = False                # ZeRO-1 optimizer sharding over dp_axis
    pp: int = 1                        # pipeline stages (graph-level)
    microbatches: int = 1              # pipeline microbatches per step
    schedule: str = "1f1b"             # pipeline schedule (see core.schedules)
    vstages: int = 1                   # virtual stages/chunks (interleaved)
    placement: tuple = ()              # axis order on the rank grid,
                                       # innermost first ("pp" included);
                                       # () = mesh order, pp outermost

    def __post_init__(self):
        for ax in (self.dp_axis, self.tp_axis, self.cp_axis, self.ep_axis):
            if ax is not None and ax not in self.axes:
                raise ValueError(f"axis {ax!r} not in mesh {self.axes}")
        if self.sp and not self.tp_axis:
            raise ValueError("sequence parallelism requires tensor parallelism")
        if (self.fsdp or self.zero1) and not self.dp_axis:
            raise ValueError("FSDP/ZeRO-1 require a dp axis")
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {self.microbatches}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule {self.schedule!r} not in {SCHEDULES}")
        if self.vstages < 1:
            raise ValueError(f"vstages must be >= 1, got {self.vstages}")
        if self.vstages > 1 and self.schedule != "interleaved":
            raise ValueError(
                f"vstages={self.vstages} requires schedule='interleaved' "
                f"(got {self.schedule!r})")
        if self.placement:
            self.placement = tuple(self.placement)
            names = set(self.axes) | {"pp"}
            unknown = [a for a in self.placement if a not in names]
            if unknown:
                raise ValueError(
                    f"placement axes {unknown} not in mesh {self.axes} + pp")
            if len(set(self.placement)) != len(self.placement):
                raise ValueError(f"placement {self.placement} repeats an axis")
            missing = [a for a in self.axes if a not in self.placement]
            if missing:
                raise ValueError(
                    f"placement {self.placement} must order every mesh axis "
                    f"(missing {missing})")
            if "pp" not in self.placement:
                self.placement = self.placement + ("pp",)

    def validate_workload(self, batch: Optional[int] = None) -> None:
        """Feasibility checks that need the workload shape (called by DSE
        sweeps before evaluating a point; raises
        :class:`~repro_torch.core.matcher.InfeasibleConfigError` so the point
        is recorded as skipped instead of silently producing fractional
        microbatch work)."""
        if batch is not None:
            dp = self.degree(self.dp_axis)
            # mirrors _act_input_spec: a batch dim that does not divide
            # dp is left unsharded (replicated), so every rank then
            # owns the FULL batch and that is what microbatches must cut
            per_rank = batch // dp if batch % dp == 0 else batch
            if per_rank % self.microbatches != 0:
                raise InfeasibleConfigError(
                    f"microbatches={self.microbatches} does not divide the "
                    f"per-dp-rank batch {per_rank} (batch={batch}, dp={dp})")
        # interleaved needs microbatches % pp == 0 (raised by the generator)
        build_schedule(self.schedule, self.pp, self.microbatches, self.vstages)

    @property
    def mesh(self) -> dict[str, int]:
        return dict(self.axes)

    def degree(self, axis: Optional[str]) -> int:
        return self.axes[axis] if axis else 1

    @property
    def world(self) -> int:
        out = self.pp
        for v in self.axes.values():
            out *= v
        return out

    def describe(self) -> str:
        bits = []
        for k, ax in (("DP", self.dp_axis), ("TP", self.tp_axis),
                      ("CP", self.cp_axis), ("EP", self.ep_axis)):
            if ax:
                bits.append(f"{k}={self.axes[ax]}")
        if self.pp > 1:
            sched = "" if self.schedule == "1f1b" else f"/{self.schedule}"
            vs = f"v{self.vstages}" if self.vstages > 1 else ""
            bits.append(f"PP={self.pp}{sched}{vs}")
        if self.microbatches > 1:
            bits.append(f"mb={self.microbatches}")
        if self.sp:
            bits.append("SP")
        if self.fsdp:
            bits.append("FSDP")
        if self.zero1:
            bits.append("ZeRO1")
        if self.placement and self.placement != tuple(self.axes) + ("pp",):
            bits.append("place=" + ".".join(self.placement))
        return ",".join(bits) or "single"


ROLES = ("tp_col", "tp_row", "vocab", "expert", "kv_heads", "none")


# --------------------------------------------------------------------------
# Divisibility guards
#
# Every *structural* decision the distributor makes that depends on mesh
# DEGREES (rather than on axis names / flags) is a divisibility test:
# "does dim value d split evenly over the product of these axes?".  The
# compiled backend (compiled.py) records these predicates while tracing
# one reference distribution and replays them as guards: any config with
# the same axis names/flags and the same guard outcomes shares the same
# distributed graph structure, so its numeric workload can be produced
# without re-running the distributor (JAX-style trace-and-guard caching).
# --------------------------------------------------------------------------

_guard_log: contextvars.ContextVar = contextvars.ContextVar(
    "stage_dist_guards", default=None)


@contextlib.contextmanager
def record_guards():
    """Collect ``(dim value, axis names, outcome)`` divisibility predicates
    evaluated by :func:`distribute` within the block."""
    log: dict = {}
    token = _guard_log.set(log)
    try:
        yield log
    finally:
        _guard_log.reset(token)


def _div_ok(env: Env, expr, cfg: "ParallelCfg", axes: tuple[str, ...]) -> bool:
    """Guarded divisibility test: ``env(expr) % prod(cfg.axes[a]) == 0``."""
    val = env.evaluate(expr)
    deg = 1
    for a in axes:
        deg *= cfg.axes[a]
    ok = val % deg == 0
    log = _guard_log.get()
    if log is not None:
        log[(val, axes)] = ok
    return ok


def guards_match_degrees(guards: dict, degrees: dict) -> bool:
    """Evaluate a recorded guard set on a bare axis-degree assignment.

    This is the static-prover entry point: the divisibility predicates
    depend on a config ONLY through its axis degrees, so checking every
    point of the (small, saturated) degree lattice proves a partition
    property for every concrete config — microbatches, schedules,
    placements, and batch shapes never enter a guard."""
    for (val, axes), ok in guards.items():
        deg = 1
        for a in axes:
            deg *= degrees[a]
        if (val % deg == 0) != ok:
            return False
    return True


def guards_match(guards: dict, cfg: "ParallelCfg") -> bool:
    """Would ``cfg`` take the same structural path as the recorded run?"""
    return guards_match_degrees(guards, cfg.axes)


def guard_levels(guards: dict) -> dict:
    """Per axis-name tuple, the sorted distinct dim values its recorded
    divisibility predicates test — the thresholds of the guard lattice.

    Degrees beyond every threshold's largest power-of-two divisor are
    indistinguishable to the guard set (``val % deg`` is nonzero for all
    of them), so a prover can saturate the lattice with finitely many
    abstract degree assignments (see ``repro_torch.analysis.prover``)."""
    levels: dict = {}
    for (val, axes), _ok in guards.items():
        levels.setdefault(axes, set()).add(val)
    return {axes: tuple(sorted(vals)) for axes, vals in levels.items()}


def weight_storage_spec(w: STensor, cfg: ParallelCfg, env: Env) -> ShardSpec:
    """Map template roles -> mesh axes (Table III strategies)."""
    part: dict[int, tuple[str, ...]] = {}
    roles: dict[int, str] = getattr(w, "roles", {}) or {}
    used: set[str] = set()
    for dim, role in roles.items():
        axis = None
        if role in ("tp_col", "tp_row", "vocab"):
            axis = cfg.tp_axis
        elif role == "expert":
            axis = cfg.ep_axis
        elif role == "kv_heads":
            axis = cfg.tp_axis
            # GQA with few kv heads: cannot shard below 1 head (e.g. MQA kv=1)
            if axis and not _div_ok(env, w.shape[dim], cfg, (axis,)):
                axis = None
        if axis and axis not in used and _div_ok(env, w.shape[dim], cfg, (axis,)):
            part[dim] = (axis,)
            used.add(axis)
    if cfg.fsdp and cfg.dp_axis and cfg.dp_axis not in used:
        # ZeRO-3: shard storage over dp on the first evenly-divisible dim.
        for dim in range(w.rank):
            cur = part.get(dim, ())
            if _div_ok(env, w.shape[dim], cfg, cur + (cfg.dp_axis,)):
                part[dim] = cur + (cfg.dp_axis,)
                break
    return ShardSpec.make(part)


def _act_input_spec(cfg: ParallelCfg, shape, env: Env,
                    batch_dim: int = 0, seq_dim: Optional[int] = 1) -> ShardSpec:
    part: dict[int, tuple[str, ...]] = {}
    if len(shape) <= batch_dim:
        return REPLICATED
    if cfg.dp_axis and _div_ok(env, shape[batch_dim], cfg, (cfg.dp_axis,)):
        part[batch_dim] = (cfg.dp_axis,)
    if (cfg.cp_axis and seq_dim is not None and len(shape) > seq_dim
            and _div_ok(env, shape[seq_dim], cfg, (cfg.cp_axis,))):
        part[seq_dim] = (cfg.cp_axis,)
    return ShardSpec.make(part)


@dataclass
class DistReport:
    comms_inserted: int = 0
    by_coll: dict = field(default_factory=dict)


class Distributor:
    def __init__(self, graph: Graph, cfg: ParallelCfg, env: Env):
        self.g = graph
        self.cfg = cfg
        self.env = env
        self.report = DistReport()
        # comm CSE: a tensor re-laid-out once per phase is reused by all
        # consumers in that phase (matches real frameworks: one AllGather
        # feeds q/k/v; backward re-gathers — FSDP/SP semantics).
        self._comm_cache: dict = {}
        # storage specs are pure in (weight, cfg): compute once per weight
        self._wspec_cache: dict[int, ShardSpec] = {}

    def _wspec(self, w: STensor) -> ShardSpec:
        spec = self._wspec_cache.get(w.uid)
        if spec is None:
            spec = weight_storage_spec(w, self.cfg, self.env)
            self._wspec_cache[w.uid] = spec
        return spec

    # -- helpers -----------------------------------------------------------
    def _unshard_weight(self, spec: ShardSpec) -> ShardSpec:
        """Compute-time weight layout: FSDP storage shards gathered."""
        if not self.cfg.fsdp or not self.cfg.dp_axis:
            return spec
        return spec.drop_axis(self.cfg.dp_axis)

    def _fix(self, b: GraphBuilder, op: Op, i: int, desired: ShardSpec) -> None:
        t = op.ins[i]
        if _canon(t.spec) == _canon(desired):
            return
        key = (t.uid, _canon(desired), op.phase)
        cached = self._comm_cache.get(key)
        if cached is not None:
            op.ins[i] = cached
            return
        fixed = insert_comms(b, t, desired, phase=op.phase, tags=op.tags)
        if fixed is not t:
            op.ins[i] = fixed
            self._comm_cache[key] = fixed
            self.report.comms_inserted += 1

    # -- per-op desired input specs + output inference ----------------------
    def _einsum(self, b: GraphBuilder, op: Einsum) -> None:
        cfg, env = self.cfg, self.env
        claims: dict[str, list[str]] = {}          # letter -> [axes]
        axis_owner: dict[str, str] = {}            # axis -> letter
        order = sorted(range(len(op.ins)),
                       key=lambda i: 0 if op.ins[i].kind == "weight" else 1)
        # gather candidate claims first; for each axis prefer a letter that
        # survives to the output (keeps results sharded instead of
        # PartialSum — e.g. Megatron's dW keeps the ffn dim sharded and
        # AllGathers the small seq-sharded grad instead)
        candidates: dict[str, list[str]] = {}
        for i in order:
            t, letters = op.ins[i], op.in_specs[i]
            base = t.spec
            if t.kind == "weight":
                base = self._unshard_weight(self._wspec(t))
            for dim, axis in base.partition:
                candidates.setdefault(axis, []).append(letters[dim])
        for axis, letts in candidates.items():
            out_letts = [l for l in letts if l in op.out_spec]
            chosen = out_letts[0] if out_letts else letts[0]
            axis_owner[axis] = chosen
            claims.setdefault(chosen, []).append(axis)
        desired: dict[int, ShardSpec] = {}
        for i in order:
            t, letters = op.ins[i], op.in_specs[i]
            base = t.spec
            if t.kind == "weight":
                base = self._unshard_weight(self._wspec(t))
            part: dict[int, tuple[str, ...]] = {}
            for dim, axis in base.partition:
                if axis_owner.get(axis) == letters[dim]:
                    part[dim] = part.get(dim, ()) + (axis,)
                # else: conflicting claim -> drop (matcher will AllGather)
            desired[i] = ShardSpec.make(part)      # partials always resolved
        # enforce claimed letters on operands sharing them
        for axis, letter in axis_owner.items():
            for i in order:
                letters = op.in_specs[i]
                dim = letters.find(letter)
                if dim < 0:
                    continue
                spec = desired[i]
                if axis in spec.all_axes:
                    continue
                if not _div_ok(env, op._dims[letter], cfg, (axis,)):
                    continue
                desired[i] = spec.with_partition(dim, axis)
        for i in range(len(op.ins)):
            self._fix(b, op, i, desired[i])
        # output spec
        out_part: dict[int, tuple[str, ...]] = {}
        partial: list[str] = []
        for letter, axes in claims.items():
            pos = op.out_spec.find(letter)
            if pos >= 0:
                out_part[pos] = tuple(axes)
            else:
                partial.extend(axes)
        op.out.spec = ShardSpec.make(out_part, tuple(sorted(partial)))

    def _elementwise(self, b: GraphBuilder, op: Op) -> None:
        """Map-like ops: broadcast-align all inputs to the highest-rank
        (layout-defining) operand."""
        cfg = self.cfg
        ref_i = max(range(len(op.ins)),
                    key=lambda i: (op.ins[i].rank,
                                   len(op.ins[i].spec.partition), -i))
        ref = op.ins[ref_i]
        desired_ref = ShardSpec(ref.spec.partition, ())
        if (cfg.sp and cfg.tp_axis and isinstance(op, Map) and op.linear
                and op.fn == "add" and ref.rank >= 3):
            # Megatron SP: the residual stream lives sequence-sharded; block
            # outputs land here as PartialSums -> the matcher emits the
            # characteristic ReduceScatter instead of an AllReduce.
            used = {a for _, a in desired_ref.partition}
            if cfg.tp_axis not in used \
                    and _div_ok(self.env, ref.shape[1], cfg, (cfg.tp_axis,)):
                desired_ref = desired_ref.with_partition(1, cfg.tp_axis)
        if desired_ref != ref.spec:
            self._fix(b, op, ref_i, desired_ref)
            ref = op.ins[ref_i]
        ref_spec = ref.spec
        out_rank = op.out.rank
        for i, t in enumerate(op.ins):
            if i == ref_i:
                continue
            part: dict[int, tuple[str, ...]] = {}
            off = out_rank - t.rank
            for dim, axis in ref_spec.partition:
                # ref dims align right against out rank
                rdim = dim + (out_rank - ref.rank)
                tdim = rdim - off
                if 0 <= tdim < t.rank and t.shape[tdim] != 1 \
                        and t.shape[tdim] == ref.shape[dim]:
                    part[tdim] = part.get(tdim, ()) + (axis,)
            self._fix(b, op, i, ShardSpec.make(part))
        # output: inherit ref partitions (mapped to out dims)
        out_part = {dim + (out_rank - ref.rank): ref_spec.axes_of_dim(dim)
                    for dim, _ in ref_spec.partition}
        op.out.spec = ShardSpec.make({d: a for d, a in out_part.items() if a})

    def _ce(self, b: GraphBuilder, op: CrossEntropy) -> None:
        # logits: resolve partial, keep vocab/batch shards; labels follow tokens
        logits = op.ins[0]
        self._fix(b, op, 0, ShardSpec(logits.spec.partition, ()))
        logits = op.ins[0]
        labels = op.ins[1]
        part: dict[int, tuple[str, ...]] = {}
        for dim, axis in logits.spec.partition:
            if dim < labels.rank:
                part[dim] = part.get(dim, ()) + (axis,)
        self._fix(b, op, 1, ShardSpec.make(part))
        tok_part = {d: logits.spec.axes_of_dim(d) for d in range(op.out.rank)
                    if logits.spec.axes_of_dim(d)}
        vocab_axes = logits.spec.axes_of_dim(logits.rank - 1)
        op.out.spec = ShardSpec.make(tok_part, tuple(vocab_axes))

    def _norm(self, b: GraphBuilder, op: Norm) -> None:
        cfg = self.cfg
        x = op.ins[0]
        part = {d: x.spec.axes_of_dim(d) for d, _ in x.spec.partition}
        part.pop(x.rank - 1, None)                     # normalized dim full
        if cfg.sp and cfg.tp_axis and x.rank >= 3:
            # Megatron SP: residual-stream activations sharded on sequence
            used = {a for axes in part.values() for a in axes}
            if cfg.tp_axis not in used \
                    and _div_ok(self.env, x.shape[1], cfg, (cfg.tp_axis,)):
                part[1] = part.get(1, ()) + (cfg.tp_axis,)
        desired = ShardSpec.make({d: a for d, a in part.items() if a})
        self._fix(b, op, 0, desired)
        self._fix(b, op, 1, REPLICATED)                # norm weight duplicated
        op.out.spec = op.ins[0].spec

    def _softmax(self, b: GraphBuilder, op: Softmax) -> None:
        x = op.ins[0]
        part = {d: x.spec.axes_of_dim(d) for d, _ in x.spec.partition}
        part.pop(op.dim, None)                         # softmax dim full
        self._fix(b, op, 0, ShardSpec.make({d: a for d, a in part.items() if a}))
        op.out.spec = op.ins[0].spec

    def _reduce(self, b: GraphBuilder, op: Reduce) -> None:
        x = op.ins[0]
        self._fix(b, op, 0, ShardSpec(x.spec.partition, ()))
        x = op.ins[0]
        partial: list[str] = []
        out_part: dict[int, tuple[str, ...]] = {}
        kept = [d for d in range(x.rank) if d not in op.dims] if not op.keepdims \
            else list(range(x.rank))
        for dim, axis in x.spec.partition:
            if dim in op.dims and not op.keepdims:
                partial.append(axis)
            elif op.keepdims and dim in op.dims:
                partial.append(axis)
            else:
                nd = kept.index(dim)
                out_part[nd] = out_part.get(nd, ()) + (axis,)
        op.out.spec = ShardSpec.make(out_part, tuple(sorted(partial)))

    def _pscan(self, b: GraphBuilder, op: PScan) -> None:
        for i in (0, 1):
            x = op.ins[i]
            part = {d: x.spec.axes_of_dim(d) for d, _ in x.spec.partition}
            part.pop(op.seq_dim, None)                 # scan dim must be local
            self._fix(b, op, i, ShardSpec.make({d: a for d, a in part.items() if a}))
        # align gate spec to value spec
        self._fix(b, op, 0, op.ins[1].spec)
        op.out.spec = op.ins[1].spec

    def _embed(self, b: GraphBuilder, op: Embed) -> None:
        table, ids = op.ins
        store = self._wspec(table)
        self._fix(b, op, 0, self._unshard_weight(store))
        table = op.ins[0]
        ids_spec = _act_input_spec(self.cfg, ids.shape, self.env)
        self._fix(b, op, 1, ids_spec)
        ids = op.ins[1]
        out_part = {d: ids.spec.axes_of_dim(d) for d, _ in ids.spec.partition}
        vocab_axes = table.spec.axes_of_dim(0)         # vocab-parallel -> partial
        hid_axes = table.spec.axes_of_dim(table.rank - 1)
        if hid_axes:
            out_part[op.out.rank - 1] = hid_axes
        op.out.spec = ShardSpec.make({d: a for d, a in out_part.items() if a},
                                     tuple(vocab_axes))

    def _transpose(self, b: GraphBuilder, op: Transpose) -> None:
        x = op.ins[0]
        self._fix(b, op, 0, ShardSpec(x.spec.partition, ()))
        x = op.ins[0]
        mapping = {p: i for i, p in enumerate(op.perm)}
        op.out.spec = x.spec.remap_dims(mapping)

    def _reshape(self, b: GraphBuilder, op: Reshape) -> None:
        x = op.ins[0]
        keep = {d: x.spec.axes_of_dim(d) for d, _ in x.spec.partition
                if d in op.dim_map}
        self._fix(b, op, 0, ShardSpec.make(
            {d: a for d, a in keep.items()},
            ()))
        x = op.ins[0]
        op.out.spec = x.spec.remap_dims(op.dim_map)

    def _topk(self, b: GraphBuilder, op: TopK) -> None:
        x = op.ins[0]
        part = {d: x.spec.axes_of_dim(d) for d, _ in x.spec.partition}
        part.pop(x.rank - 1, None)                     # full over experts dim
        self._fix(b, op, 0, ShardSpec.make({d: a for d, a in part.items() if a}))
        x = op.ins[0]
        for o in op.outs:
            o.spec = ShardSpec(x.spec.partition, ())

    def _dispatch(self, b: GraphBuilder, op: Dispatch) -> None:
        cfg = self.cfg
        x, idx = op.ins
        if not op.combine:
            # tokens in [B,S,H]: keep dp on batch, gather anything else
            want = _act_input_spec(cfg, x.shape, self.env, batch_dim=0, seq_dim=None)
            self._fix(b, op, 0, want)
            self._fix(b, op, 1, _act_input_spec(cfg, idx.shape, self.env,
                                                batch_dim=0, seq_dim=None))
            x = op.ins[0]
            token_axes = x.spec.axes_of_dim(0)
            # produced: each dp shard emitted its own tokens -> capacity dim shard
            op.out.spec = ShardSpec.make({1: token_axes} if token_axes else {})
        else:
            # combine: [E,C,H] -> tokens [B,S,H]
            cap_axes = x.spec.axes_of_dim(1) or x.spec.axes_of_dim(0)
            want_part: dict[int, tuple[str, ...]] = {}
            if cfg.ep_axis and x.spec.axes_of_dim(0):
                # tokens owned per-dp-rank again: expert shards -> capacity shards
                want_part = {1: x.spec.axes_of_dim(0)}
                self._fix(b, op, 0, ShardSpec.make(want_part))
            x = op.ins[0]
            out_axes = x.spec.axes_of_dim(1)
            op.out.spec = ShardSpec.make({0: out_axes} if out_axes else {})

    def _scatter_add(self, b: GraphBuilder, op: ScatterAdd) -> None:
        table = getattr(op, "table", None)
        store = self._wspec(table) if table is not None else ShardSpec()
        vocab_axes = set(store.axes_of_dim(0))
        g = op.ins[0]
        # grads must be full along axes that shard the vocab dim (each rank
        # scatters only its local vocab rows — Megatron vocab-parallel bwd);
        # other partitions stay and become PartialSums
        keep = {d: tuple(a for a in g.spec.axes_of_dim(d)
                         if a not in vocab_axes)
                for d, _ in g.spec.partition}
        self._fix(b, op, 0, ShardSpec.make(
            {d: a for d, a in keep.items() if a}))
        g = op.ins[0]
        partial = [a for d, a in g.spec.partition if d < g.rank - 1]
        part = {d: a for d, a in ((0, tuple(vocab_axes)),) if a}
        last_axes = tuple(a for a in g.spec.axes_of_dim(g.rank - 1)
                          if a not in vocab_axes)
        if last_axes:
            part[op.out.rank - 1] = last_axes
        op.out.spec = ShardSpec.make(part, tuple(sorted(partial)))

    def _update(self, b: GraphBuilder, op: Update) -> None:
        cfg, env = self.cfg, self.env
        w, g = op.ins
        store = self._wspec(w)
        shard = store
        if cfg.zero1 and cfg.dp_axis and cfg.dp_axis not in store.all_axes:
            # ZeRO-1: shard the *update* over dp even though storage is full
            for dim in range(w.rank):
                cur = store.axes_of_dim(dim)
                if _div_ok(env, w.shape[dim], cfg, cur + (cfg.dp_axis,)):
                    shard = store.with_partition(dim, cfg.dp_axis)
                    break
        w.spec = store
        self._fix(b, op, 0, shard)        # slice param locally if ZeRO-1
        self._fix(b, op, 1, shard)        # grads: AllReduce (DP) / RS (FSDP,ZeRO-1)
        for o in op.outs:
            o.spec = shard
        if shard != store:
            # fresh params must return to storage layout (ZeRO-1 AllGather)
            insert_comms(b, op.outs[0], store, phase="opt", tags=op.tags)

    # -- main pass -----------------------------------------------------------
    def run(self) -> DistReport:
        cfg, env, g = self.cfg, self.env, self.g
        for w in g.weights:
            w.spec = weight_storage_spec(w, cfg, env)
        for t in g.inputs:
            if t.kind == "index" or t.rank <= 2:
                t.spec = _act_input_spec(cfg, t.shape, env,
                                         seq_dim=1 if t.rank > 1 else None)
            else:
                t.spec = _act_input_spec(cfg, t.shape, env)

        old_ops = list(g.ops)
        g.ops = []
        b = GraphBuilder(g)
        b._names = {op.name: 1 for op in old_ops}
        for op in old_ops:
            # matcher-inserted ops already carry final specs; template/vjp
            # SliceLikes must flow through the elementwise rule
            if isinstance(op, Comm) or getattr(op, "_matcher", False):
                g.ops.append(op)
                continue
            if isinstance(op, Einsum):
                self._einsum(b, op)
            elif isinstance(op, Norm):
                self._norm(b, op)
            elif isinstance(op, Softmax):
                self._softmax(b, op)
            elif isinstance(op, Reduce):
                self._reduce(b, op)
            elif isinstance(op, PScan):
                self._pscan(b, op)
            elif isinstance(op, Embed):
                self._embed(b, op)
            elif isinstance(op, Transpose):
                self._transpose(b, op)
            elif isinstance(op, Reshape):
                self._reshape(b, op)
            elif isinstance(op, TopK):
                self._topk(b, op)
            elif isinstance(op, Dispatch):
                self._dispatch(b, op)
            elif isinstance(op, CrossEntropy):
                self._ce(b, op)
            elif isinstance(op, ScatterAdd):
                self._scatter_add(b, op)
            elif isinstance(op, Update):
                self._update(b, op)
            elif isinstance(op, Map):
                self._elementwise(b, op)
            else:
                self._elementwise(b, op)
            g.ops.append(op)
        for op in g.ops:
            if isinstance(op, Comm):
                self.report.by_coll[op.coll] = self.report.by_coll.get(op.coll, 0) + 1
        return self.report


def distribute(graph: Graph, cfg: ParallelCfg, env: Env) -> DistReport:
    """Apply tensor-level distribution in place; returns a comm report."""
    return Distributor(graph, cfg, env).run()
