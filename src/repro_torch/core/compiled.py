"""Compiled numeric evaluation backend: lambdified cost programs.

The reference pipeline pays per-op sympy ``expr.subs(env)`` for every
config point of a DSE sweep: ``instantiate`` builds a fresh
``prod(local_shape(mesh))`` expression per tensor per point (mesh
degrees differ, so the Env cache always misses).  This module lowers a
*distributed* STG once into a flat numeric cost program and replays it
per config as plain array arithmetic:

* **Coefficients** — every config-independent sympy expression the cost
  model needs (tensor numels, einsum letter extents, weight element
  counts) is collected, deduplicated, and evaluated in one shot through
  ``sympy.lambdify`` over the model symbols.
* **Partition factors** — mesh-degree dependence is purely structural:
  a local size is ``numel / prod(deg(axis)^k)``, an einsum's FLOPs divide
  per sharded letter, a collective's volume divides by its group.  The
  lowering records the axis-name exponents; evaluation plugs in the
  config's degrees (vectorized over the tensor table with numpy).
* **Structure classes** — which collectives exist depends on the config
  only through its axis names/flags and the divisibility predicates the
  distributor evaluates.  :class:`CompiledBackend` traces one reference
  ``distribute`` per class under :func:`~repro_torch.core.distribute.record_guards`
  and reuses the lowered program for every config whose guards match
  (JAX-style trace-and-guard caching) — ``distribute`` itself drops out
  of the per-point cost.

The numeric kernels mirror the reference formulas (stg.py /
instantiate.py / memory.py) operation-for-operation in the same
float-arithmetic order, so the produced :class:`~repro_torch.core.instantiate.Workload`
and :class:`~repro_torch.core.memory.MemoryReport` are bit-identical to the
sympy path (asserted by tests/test_backend_parity.py for every bundled
model config).  ``Env.evaluate`` stays available as the reference
backend (``backend="sympy"``).
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import sympy as sp

from ..obs import metrics as _metrics
from ..obs.spans import span as _span
from .distribute import DistReport, ParallelCfg, distribute, guards_match, \
    record_guards
from .graphdist import _stage_for_tags
from .instantiate import NodeRec, Workload
from .memory import MemoryReport
from .schedules import inflight_factor
from .stg import (CAT_COMM, Comm, CrossEntropy, Einsum, Graph, Map, Norm,
                  PScan, Reduce, ScatterAdd, SendRecv, Softmax, TopK, Update)
from .symbolic import Env, prod
from .tensor import DTYPE_BYTES

__all__ = ["CompiledBackend", "CostProgram", "collective_wire"]


@functools.lru_cache(maxsize=65536)
def _numel_expr(shape: tuple) -> sp.Expr:
    """Cached ``prod(shape)``: shape tuples are shared between graph
    clones (STensor.clone shares the sympy payload), so every structure
    class after the first reuses the Mul instead of rebuilding it."""
    return prod(shape)

_PER_RANK_COLLS = ("AllReduce", "Broadcast", "Reduce", "Gather", "Scatter")
_RING_COLLS = ("AllGather", "ReduceScatter", "Gather", "Scatter",
               "Broadcast", "Reduce")


def collective_wire(coll: str, size, n):
    """Ring-term wire bytes and step count of one collective: the single
    lowered formula table shared by workload replay
    (:meth:`CostProgram.instantiate`) and the branch-and-bound floor
    (:func:`repro_torch.core.dse._cell_floor`).

    Pure arithmetic in ``size`` and ``n`` — callers may pass floats (the
    numeric replay) or sympy symbols (the static prover checks these
    formulas against the independent invariant table in
    :mod:`repro_torch.analysis.comm_checks` as exact symbolic identities).
    Callers handle the degenerate ``n <= 1`` group themselves (wire is
    zero; the formulas below assume a real ring)."""
    if coll == "AllReduce":
        return size * 2 * (n - 1) / n, 2 * (n - 1)
    if coll in _RING_COLLS or coll == "AllToAll":
        return size * (n - 1) / n, n - 1
    return size, n - 1


def _axis_counts(axes) -> tuple:
    """``(axis, multiplicity)`` pattern for a partition's axis list."""
    if not axes:
        return ()
    if len(axes) == 1:
        return ((axes[0], 1),)
    counts: dict = {}
    for a in axes:
        counts[a] = counts.get(a, 0) + 1
    return tuple(sorted(counts.items()))


def _prod_degrees(mesh: dict, pattern) -> int:
    d = 1
    for a, k in pattern:
        d *= mesh[a] ** k
    return d


@dataclass
class _NodeProg:
    """Per-op numeric recipe (indices into the program's tensor table)."""
    name: str
    kind: str
    category: str
    phase: str
    tags: dict
    ins: tuple            # tidx of op.ins, in order
    outs: tuple           # tidx of op.outs, in order
    outb: tuple           # outs contributing to out_bytes (index kind skipped)
    flop: Optional[tuple]  # ("scale", s, tidx) | ("einsum", node-local key)
    comm: Optional[tuple]  # (coll, axis, ref_tidx, other_axes w/ multiplicity)
    upd: Optional[tuple]   # (w_tidx, shard_axes, grad_axes) for Update ops
    fused: bool
    wgrad: bool            # bwd node producing a weight grad (zb split)


@dataclass
class _SRProg:
    """A pipeline Send/Recv synthesized for a (tensor, dst chunk) edge."""
    src: int              # real tidx of the crossing tensor
    vid: int              # virtual tidx of the recv-side tensor
    name: str
    phase: str
    tags: dict
    stage: int            # physical stage (chunk % pp)
    vstage: int           # destination chunk


@dataclass
class _Layout:
    """Pipeline-cut execution plan for one ``(pp, vstages)`` pair.

    ``entries`` holds one pre-resolved template per emitted node —
    everything that does not depend on mesh degrees (uid, deps, stage,
    byte-index lists) is frozen here, so per-config replay is a tight
    loop of float sums over the local-size arrays."""
    seq: list             # ("op", node_idx, stage, remapped_ins, chunk) | ("sr", _SRProg)
    src_of: dict          # virtual tidx -> real tidx
    entries: list = field(default_factory=list)
    stage_of: dict = field(default_factory=dict)   # node uid -> stage
    mem_static: dict = field(default_factory=dict)  # stage -> precomputed


class CostProgram:
    """One structure class: a distributed STG lowered to flat arrays.

    Construction = lower + bind: collect/deduplicate the coefficient
    expressions, evaluate them once via ``sympy.lambdify`` under ``env``,
    and record per-op recipes.  The source graph is NOT retained —
    everything needed at evaluation time lives in plain arrays.

    Fresh workloads (the Trace path) own their node ``tags`` dicts and
    stage map like the reference backend; only internal scratch replays
    (``reuse=True``, consumed immediately by the sweep driver) share
    them with the program."""

    def __init__(self, graph: Graph, env: Env, *, n_layers: int,
                 guards: dict, report: DistReport):
        self.env = env
        self.n_layers = n_layers
        self.guards = guards
        self.report = report
        self._layouts: dict[tuple, _Layout] = {}   # (pp, vstages) -> layout
        self._point_cache: dict[tuple, tuple] = {}
        self._scratch: dict[tuple, Workload] = {}   # (thread id, pp) -> wl

        # ---- tensor table ------------------------------------------------
        exprs: list = []
        expr_ix: dict = {}

        def ci(expr) -> int:
            if not isinstance(expr, sp.Basic):
                expr = sp.sympify(expr)
            i = expr_ix.get(expr)
            if i is None:
                i = len(exprs)
                expr_ix[expr] = i
                exprs.append(expr)
            return i

        tensors = graph.tensors()
        tidx = {t.uid: i for i, t in enumerate(tensors)}
        self._tname = [t.name for t in tensors]
        self._tkind = [t.kind for t in tensors]
        t_ci = [ci(_numel_expr(t.shape)) for t in tensors]
        t_part = [_axis_counts([a for _, a in t.spec.partition])
                  for t in tensors]
        t_db = [DTYPE_BYTES[t.dtype] for t in tensors]
        self._roots = {tidx[t.uid] for t in graph.inputs + graph.weights}

        # ---- node recipes ------------------------------------------------
        self.nodes: list[_NodeProg] = []
        self._eins: dict[int, tuple] = {}      # node idx -> ((dim_ci, axes), ...)
        for op in graph.ops:
            ins = tuple(tidx[t.uid] for t in op.ins)
            outs = tuple(tidx[t.uid] for t in op.outs)
            outb = tuple(tidx[t.uid] for t in op.outs if t.kind != "index")
            flop = comm = upd = None
            if isinstance(op, Einsum):
                letters = sorted(set("".join(op.in_specs)) | set(op.out_spec))
                self._eins[len(self.nodes)] = tuple(
                    (ci(op._dims[let]), op.letter_shard_axes(let))
                    for let in letters)
                flop = ("einsum",)
            elif isinstance(op, Map):
                flop = ("scale", op.flop_per_elem, outs[0])
            elif isinstance(op, (Reduce, ScatterAdd, TopK)):
                flop = ("scale", 1.0, ins[0])
            elif isinstance(op, (Softmax, CrossEntropy)):
                ref = outs[0] if isinstance(op, Softmax) else ins[0]
                flop = ("scale", 5.0, ref)
            elif isinstance(op, Norm):
                flop = ("scale", 4.0, outs[0])
            elif isinstance(op, PScan):
                flop = ("scale", 2.0, outs[0])
            elif isinstance(op, Update):
                flop = ("scale", 12.0, outs[0])
                w, g = op.ins
                shard = op.outs[1].spec
                upd = (tidx[w.uid],
                       tuple(a for _, a in shard.partition),
                       tuple(a for _, a in g.spec.partition))
            if isinstance(op, Comm):
                ref = op.out if op.coll == "AllGather" else op.ins[0]
                other = tuple(a for _, a in ref.spec.partition
                              if a != op.axis)
                comm = (op.coll, op.axis, tidx[ref.uid], other)
            self.nodes.append(_NodeProg(
                name=op.name, kind=op.kind, category=op.category,
                phase=op.phase, tags=dict(op.tags), ins=ins, outs=outs,
                outb=outb, flop=flop, comm=comm, upd=upd,
                fused=bool(op.tags.get("fused")),
                wgrad=any(t.kind == "grad" for t in op.outs)))

        # ---- bind: one lambdified evaluation of all coefficients ---------
        # lowering state kept for re-binding (the decode series replays
        # the SAME lowered structure under a sweep of Skv values)
        self._exprs = exprs
        self._t_ci = t_ci
        self._t_db = t_db
        self._t_part = t_part
        self._nt = len(tensors)
        self._db = np.asarray(t_db, dtype=np.float64)
        groups: dict[tuple, list[int]] = {}
        for i, pat in enumerate(t_part):
            groups.setdefault(pat, []).append(i)
        self._group_ix = [(pat, np.asarray(ix, dtype=np.intp))
                          for pat, ix in groups.items()]
        self.bind_vals(_evaluate_exprs(exprs, env))

    def bind_vals(self, vals: list) -> None:
        """(Re)bind the coefficient values this program replays.

        ``vals`` must follow ``self._exprs`` order.  The float-conversion
        points and arithmetic order are EXACTLY those of the original
        one-shot binding, so a program re-bound with exactly-evaluated
        values stays bit-identical to a fresh ``CostProgram`` built under
        the corresponding Env (the decode-series spot-check guarantee).
        Clears the per-config local-size cache; the pipeline layouts and
        lifetime structures are value-independent and survive."""
        t_ci, t_db = self._t_ci, self._t_db
        self._vals = vals
        self._groups = [
            (pat, ix,
             np.asarray([float(vals[t_ci[i]]) for i in ix], dtype=np.float64))
            for pat, ix in self._group_ix]
        # global bytes per tensor (collectives use the *unsharded* volume)
        self._gb = [float(vals[t_ci[i]] * t_db[i]) for i in range(self._nt)]
        self._wnumel = [float(vals[c]) for c in t_ci]
        # bound einsum letter extents (reference uses fevaluate -> float)
        self._eins_f = {
            i: tuple((float(vals[c]), axes) for c, axes in letters)
            for i, letters in self._eins.items()}
        self._point_cache.clear()

    # ---- batch lowering (repro_torch.core.batched) -----------------------------
    def batch_tables(self, axes: tuple) -> dict:
        """Static coefficient tables for *batched* (vectorized) replay.

        ``axes`` fixes the mesh-axis column order (normally the structure
        class's sorted axis names).  Returns plain numpy arrays —
        everything a backend needs to evaluate local sizes for a whole
        batch of configs at once:

        * ``numel``  — [nt] global element counts (bound coefficients),
        * ``dbytes`` — [nt] dtype byte widths,
        * ``gbytes`` — [nt] global byte volumes (``numel * dbytes``),
        * ``expo``   — [nt, len(axes)] mesh-degree exponents such that
          ``local_numel = numel / prod(degs ** expo)`` — exactly the
          ``_prod_degrees`` partition factors, laid out as a dense
          integer-power table.

        Raises ``ValueError`` if a tensor partitions over an axis not in
        ``axes`` (the caller sliced the mesh wrong)."""
        ax_ix = {a: j for j, a in enumerate(axes)}
        expo = np.zeros((self._nt, len(axes)), dtype=np.float64)
        for i, pat in enumerate(self._t_part):
            for a, k in pat:
                j = ax_ix.get(a)
                if j is None:
                    raise ValueError(
                        f"tensor {self._tname[i]!r} partitions over axis "
                        f"{a!r} which is not in the batch axes {axes}")
                expo[i, j] = k
        return {"numel": np.asarray(self._wnumel, dtype=np.float64),
                "dbytes": self._db.copy(),
                "gbytes": np.asarray(self._gb, dtype=np.float64),
                "expo": expo}

    def batch_bind(self, meshes, axes: Optional[tuple] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized :meth:`_local`: local (numel, bytes) arrays of
        shape ``[len(meshes), nt]`` for a batch of mesh dicts.

        This is the numpy reference semantics for the JAX batched
        backend (tests pin the two against ``_local`` per row); missing
        axes default to degree 1, matching ``ParallelCfg.axes`` never
        holding degenerate axes."""
        if axes is None:
            names: set = set()
            for m in meshes:
                names.update(m)
            axes = tuple(sorted(names))
        t = self.batch_tables(axes)
        degs = np.asarray([[float(m.get(a, 1)) for a in axes]
                           for m in meshes], dtype=np.float64)
        denom = np.prod(degs[:, None, :] ** t["expo"][None, :, :], axis=2)
        ln = t["numel"][None, :] / denom
        return ln, ln * t["dbytes"][None, :]

    # ---- per-config local sizes -----------------------------------------
    def _local(self, cfg: ParallelCfg) -> tuple[list, list]:
        """(local numel, local bytes) per tensor under cfg's mesh degrees."""
        key = tuple(sorted(cfg.axes.items()))
        hit = self._point_cache.get(key)
        if hit is not None:
            return hit
        mesh = cfg.axes
        ln = np.empty(self._nt, dtype=np.float64)
        for pat, ix, coeffs in self._groups:
            ln[ix] = coeffs / _prod_degrees(mesh, pat)
        lb = ln * self._db
        out = (ln.tolist(), lb.tolist())
        if len(self._point_cache) > 4:
            self._point_cache.clear()
        self._point_cache[key] = out
        return out

    # ---- pipeline layout (mirrors graphdist.apply_pipeline) --------------
    def _layout(self, pp: int, vstages: int = 1) -> _Layout:
        vstages = max(1, vstages) if pp > 1 else 1
        key = (pp, vstages)
        lay = self._layouts.get(key)
        if lay is not None:
            return lay
        if pp <= 1:
            seq = [("op", i, 0, p.ins, 0) for i, p in enumerate(self.nodes)]
            lay = _Layout(seq=seq, src_of={})
        else:
            chunks = pp * vstages
            producer_chunk: dict[int, int] = {}
            moved: dict[tuple, int] = {}
            src_of: dict[int, int] = {}
            seq: list = []
            vnext = self._nt
            for i, p in enumerate(self.nodes):
                c = _stage_for_tags(p.tags, chunks, self.n_layers)
                s = c % pp
                ins = list(p.ins)
                for j, t in enumerate(ins):
                    cp = producer_chunk.get(t, -1)
                    if cp in (-1, c):
                        continue
                    v = moved.get((t, c))
                    if v is None:
                        v = vnext
                        vnext += 1
                        src_of[v] = t
                        seq.append(("sr", _SRProg(
                            src=t, vid=v,
                            name=f"{self._tname[t]}_pp{cp}to{c}",
                            phase=p.phase, tags=p.tags, stage=s, vstage=c)))
                        producer_chunk[v] = c
                        moved[(t, c)] = v
                    ins[j] = v
                seq.append(("op", i, s, tuple(ins), c))
                for t in p.outs:
                    producer_chunk[t] = c
            lay = _Layout(seq=seq, src_of=src_of)
        self._freeze_entries(lay)
        self._layouts[key] = lay
        return lay

    def _kind(self, t: int) -> str:
        return self._tkind[t] if t < self._nt else "act"

    def _real(self, src_of: dict, t: int) -> int:
        return t if t < self._nt else src_of[t]

    def _freeze_entries(self, lay: _Layout) -> None:
        """Resolve everything degree-independent into per-node templates:
        (uid, name, kind, category, phase, stage, vstage, wgrad, flop,
        ba_idx, outb_idx, comm, deps, tags)."""
        src_of = lay.src_of
        prodn: dict[int, int] = {}
        uid = 0
        for entry in lay.seq:
            uid += 1
            if entry[0] == "sr":
                srp = entry[1]
                src = srp.src
                # reference bytes_accessed order: ins (index kind skipped)
                # then the recv-side tensor (always 'act', same shard)
                ba = (src, src) if self._tkind[src] != "index" else (src,)
                dep = prodn.get(src)
                lay.entries.append((
                    uid, srp.name, "SendRecv", CAT_COMM, srp.phase,
                    srp.stage, srp.vstage, False, None, ba, (src,),
                    ("SendRecv", src),
                    (dep,) if dep is not None else (), srp.tags))
                lay.stage_of[uid] = srp.stage
                prodn[srp.vid] = uid
                continue
            _, i, s, ins, c = entry
            p = self.nodes[i]
            ba = tuple(self._real(src_of, t) for t in ins
                       if self._kind(t) != "index") + p.outb
            deps = tuple(sorted({prodn[t] for t in ins if t in prodn}))
            flop = p.flop if p.flop is None or p.flop[0] == "scale" \
                else ("einsum", i)
            lay.entries.append((
                uid, p.name, p.kind, p.category, p.phase, s, c, p.wgrad,
                flop, ba, p.outb, p.comm, deps, p.tags))
            lay.stage_of[uid] = s
            for t in p.outs:
                prodn[t] = uid

    # ---- numeric instantiate (mirrors instantiate.instantiate) -----------
    def instantiate(self, cfg: ParallelCfg, name: str = "workload", *,
                    reuse: bool = False) -> Workload:
        """Replay the cost program under ``cfg``'s mesh degrees.

        ``reuse=True`` recycles a per-``pp`` scratch workload, updating
        the numeric fields of the SAME NodeRec objects in place — the
        sweep driver uses this (points are consumed immediately by
        simulate/summaries); callers that hand the workload out (Trace)
        must take a fresh one."""
        mesh = cfg.mesh
        ln, lb = self._local(cfg)
        vstages = getattr(cfg, "vstages", 1)
        lay = self._layout(cfg.pp, vstages)
        mb = cfg.microbatches
        eins = self._eins_f
        gb = self._gb
        # scratch is keyed per thread: two serial sweeps sharing the
        # process-wide engine from different threads must not mutate the
        # same NodeRec objects mid-simulate
        skey = (threading.get_ident(), cfg.pp, vstages) if reuse else None
        scratch = self._scratch.get(skey) if reuse else None
        build = scratch is None
        nodes: list[NodeRec] = [] if build else scratch.nodes
        append = nodes.append
        for k, (uid, nm, kind, cat, phase, s, vs, wgrad, flop, ba_ix, outb,
                cm, deps, tags) in enumerate(lay.entries):
            if flop is None:
                flops = 0.0
            elif flop[0] == "scale":
                flops = flop[1] * ln[flop[2]]
            else:                               # einsum letter products
                flops = 2.0
                for fval, axes in eins[flop[1]]:
                    deg = 1
                    for a in axes:
                        deg *= mesh[a]
                    flops *= fval / deg
            ba = 0.0
            for t in ba_ix:
                ba += lb[t]
            out_b = 0.0
            for t in outb:
                out_b += lb[t]
            size = wire = 0.0
            group = 1
            if cm is not None:
                if cm[0] == "SendRecv":
                    size = wire = lb[cm[1]]
                    group = 2
                else:
                    coll, axis, ref, other = cm
                    full = gb[ref]
                    n = mesh[axis]
                    other_deg = 1
                    for a in other:
                        other_deg *= mesh[a]
                    full /= other_deg
                    size = full if coll in _PER_RANK_COLLS else full / n
                    wire = 0.0 if n <= 1 else collective_wire(coll, size, n)[0]
                    group = mesh.get(axis, 1)
            repeat = 1 if phase == "opt" else mb
            if build:
                comm = None
                if cm is not None:
                    coll_axis = (("SendRecv", "pp") if cm[0] == "SendRecv"
                                 else (cm[0], cm[1]))
                    comm = {"coll": coll_axis[0], "axis": coll_axis[1],
                            "group": group, "size": size, "wire": wire}
                append(NodeRec(uid, nm, kind, cat, phase, s, flops, ba,
                               out_b, comm, deps, repeat,
                               tags if reuse else dict(tags),
                               vstage=vs, wgrad=wgrad))
            else:
                rec = nodes[k]
                rec.flops = flops
                rec.bytes_accessed = ba
                rec.out_bytes = out_b
                rec.repeat = repeat
                if cm is not None:
                    d = rec.comm
                    d["group"] = group
                    d["size"] = size
                    d["wire"] = wire
        if build:
            # fresh (user-facing) workloads get their own tags dicts and
            # stage map, matching the reference backend's isolation; the
            # internal scratch path shares them (points are consumed
            # immediately and never handed out)
            w = Workload(cfg=cfg, env=self.env, nodes=nodes,
                         stage_of=lay.stage_of if reuse
                         else dict(lay.stage_of), name=name)
            if reuse:
                if len(self._scratch) > 8:      # bound dead-thread leftovers
                    self._scratch.clear()
                self._scratch[skey] = w
            return w
        scratch.cfg = cfg
        scratch.name = name
        return scratch

    # ---- numeric peak memory (mirrors memory.peak_memory) -----------------
    def _mem_static(self, pp: int, vstages: int, stage: int) -> tuple:
        """Degree-independent lifetime structure for one (pp, vstages,
        stage): (weight tidxs, Update recipes, activation intervals)."""
        lay = self._layout(pp, vstages)
        cached = lay.mem_static.get(stage)
        if cached is not None:
            return cached
        src_of = lay.src_of
        entries = [e for e in lay.seq
                   if (e[1].stage if e[0] == "sr" else e[2]) == stage]

        w_idx: list[int] = []
        seen: set[int] = set()
        upds: list[tuple] = []
        produced_at: dict[int, int] = {}
        last_use: dict[int, int] = {}
        last_fwd_use: dict[int, int] = {}
        producer_tags: dict[int, dict] = {}
        fused: set[int] = set()
        for i, e in enumerate(entries):
            if e[0] == "sr":
                srp = e[1]
                ins, outs, phase, tags, is_fused = \
                    (srp.src,), (srp.vid,), srp.phase, srp.tags, False
            else:
                p = self.nodes[e[1]]
                ins, outs, phase, tags, is_fused = \
                    e[3], p.outs, p.phase, p.tags, p.fused
                if p.upd is not None:
                    upds.append(p.upd)
            for t in ins:
                if t < self._nt and self._tkind[t] == "weight" \
                        and t not in seen:
                    seen.add(t)
                    w_idx.append(t)
                if self._kind(t) == "act":
                    last_use[t] = i
                    if phase == "fwd":
                        last_fwd_use[t] = i
            for t in outs:
                if self._kind(t) == "act":
                    produced_at[t] = i
                    last_use[t] = max(last_use.get(t, i), i)
                    producer_tags[t] = tags
                if is_fused:
                    fused.add(t)

        acts = tuple(
            (self._real(src_of, t),                 # tidx for byte value
             start,
             last_use.get(t, start),
             last_fwd_use.get(t, start),
             producer_tags[t].get("layer"),
             t in fused)
            for t, start in produced_at.items())
        out = (tuple(w_idx), tuple(upds), acts)
        lay.mem_static[stage] = out
        return out

    def peak_memory(self, cfg: ParallelCfg, *, stage: int = 0,
                    recompute: bool = False, master_fp32: bool = True,
                    grad_dtype: str = "fp32") -> MemoryReport:
        mesh = cfg.mesh
        _, lb = self._local(cfg)
        w_idx, upds, acts = self._mem_static(cfg.pp, getattr(cfg, "vstages", 1),
                                             stage)

        weights = grads = opt_states = master = 0.0
        for t in w_idx:
            weights += lb[t]
        gdb = DTYPE_BYTES[grad_dtype]
        wnumel = self._wnumel
        for w_t, shard_axes, grad_axes in upds:
            m_bytes = wnumel[w_t] * 4
            deg = 1
            for a in shard_axes:
                deg *= mesh[a]
            opt_states += 2 * m_bytes / deg
            if master_fp32:
                master += m_bytes / deg
            gdeg = 1
            for a in grad_axes:
                gdeg *= mesh[a]
            grads += wnumel[w_t] * gdb / gdeg

        layer_act: dict = {}
        events: list[tuple[int, float]] = []
        append = events.append
        for t, start, end, end_fwd, lyr, is_fused in acts:
            b = lb[t]
            if is_fused or recompute:
                end = min(end, end_fwd)
            if recompute and lyr is not None and not is_fused:
                layer_act[lyr] = layer_act.get(lyr, 0.0) + b
            append((start, b))
            append((end + 1, -b))
        events.sort()
        cur = peak = 0.0
        for _, delta in events:
            cur += delta
            if cur > peak:
                peak = cur
        inflight = inflight_factor(getattr(cfg, "schedule", "1f1b"), cfg.pp,
                                   cfg.microbatches,
                                   getattr(cfg, "vstages", 1), stage)
        extra = max(layer_act.values(), default=0.0) if recompute else 0.0
        return MemoryReport(weights=weights, grads=grads,
                            opt_states=opt_states, master_params=master,
                            peak_activation=peak,
                            inflight_factor=inflight,
                            recompute_extra=extra)

    def state_bytes(self, cfg: ParallelCfg, *, stage: int = 0,
                    master_fp32: bool = True) -> float:
        """Per-rank persistent (checkpointable) bytes: weights +
        optimizer moments + fp32 masters — the terms
        :func:`repro_torch.ft.goodput.state_bytes` reads off a full
        :class:`MemoryReport`, without the activation event sweep.
        Accumulation order mirrors :meth:`peak_memory` term-for-term so
        the two agree bit-for-bit; serving graphs have no Update ops and
        naturally cost weights-only."""
        mesh = cfg.mesh
        _, lb = self._local(cfg)
        w_idx, upds, _ = self._mem_static(cfg.pp, getattr(cfg, "vstages", 1),
                                          stage)
        weights = opt_states = master = 0.0
        for t in w_idx:
            weights += lb[t]
        wnumel = self._wnumel
        for w_t, shard_axes, _grad_axes in upds:
            m_bytes = wnumel[w_t] * 4
            deg = 1
            for a in shard_axes:
                deg *= mesh[a]
            opt_states += 2 * m_bytes / deg
            if master_fp32:
                master += m_bytes / deg
        return float(weights + opt_states + master)

    # ---- static introspection (repro_torch.analysis.prover) ---------------------
    def introspect(self) -> dict:
        """Read-only bundle of the lowered tables for the static prover.

        Everything the symbolic-invariant passes need, as plain data (no
        graph, no sympy): per-tensor *exact* coefficient values (the
        lambdified polynomials are evaluated over exact ints, so these
        are exact), dtype byte widths, partition axis-exponent patterns,
        the per-node recipes, the exact einsum letter extents, and the
        recorded divisibility guards.  Mutating the returned containers
        does not affect the program (top-level copies), but the
        ``_NodeProg`` records are shared — treat them as frozen."""
        t_ci = self._t_ci
        return {
            "nodes": tuple(self.nodes),
            "names": tuple(self._tname),
            "kinds": tuple(self._tkind),
            "part": tuple(self._t_part),      # ((axis, exponent), ...) per tensor
            "dbytes": tuple(self._t_db),
            "numel": tuple(self._vals[c] for c in t_ci),   # exact values
            "gbytes": tuple(self._gb),        # bound floats (numel * dbytes)
            "eins": {i: tuple((self._vals[c], axes) for c, axes in letters)
                     for i, letters in self._eins.items()},
            "guards": dict(self.guards),
        }

    def layout_entries(self, pp: int, vstages: int = 1) -> list:
        """Frozen per-node execution templates of one ``(pp, vstages)``
        pipeline cut — ``(uid, name, kind, category, phase, stage,
        vstage, wgrad, flop, ba_idx, outb_idx, comm, deps, tags)``
        tuples, exactly what :meth:`instantiate` and the branch-and-bound
        floor replay.  Public handle for the bound-soundness pass."""
        return list(self._layout(max(1, pp), vstages).entries)

    def memory_static(self, pp: int, vstages: int = 1, stage: int = 0
                      ) -> tuple:
        """Degree-independent memory-lifetime structure of one stage:
        ``(weight tidxs, update recipes, activation intervals)`` — the
        inputs the monotonicity certificate reasons over."""
        return self._mem_static(max(1, pp), vstages, stage)


def _evaluate_exprs(exprs: list, env: Env) -> list:
    """Evaluate all coefficient expressions at once via ``sympy.lambdify``
    with exact Python-int inputs (polynomials stay exact ints); falls back
    to per-expression Env evaluation for anything lambdify can't handle."""
    if not exprs:
        return []
    syms = sorted({s for e in exprs for s in e.free_symbols},
                  key=lambda s: s.name)
    try:
        fn = sp.lambdify(syms, exprs, modules=["math"])
        return list(fn(*[env[s] for s in syms]))
    except Exception:
        out = []
        for e in exprs:
            try:
                out.append(env.evaluate(e))
            except ValueError:
                out.append(env.fevaluate(e))
        return out


class CompiledBackend:
    """Numeric evaluation engine for one ``(build, env)`` pair.

    Maintains the structure-class cache: configs are bucketed by their
    axis names + strategy flags, then matched against each class's
    recorded divisibility guards; the first config of a class pays one
    reference ``distribute`` + lowering, every later match is pure
    numeric replay.  Thread-safe (sweep workers share one backend)."""

    def __init__(self, build: Callable[[], Graph], env: Env, *, n_layers: int):
        self.build = build
        self.env = env
        self.n_layers = n_layers
        self._classes: dict[tuple, list[CostProgram]] = {}
        self._lock = threading.Lock()
        self.compiles = 0
        self.hits = 0

    @staticmethod
    def _structure_key(cfg: ParallelCfg) -> tuple:
        # deliberately EXCLUDES cfg.placement and cfg.schedule: axis
        # placement and pipeline schedule change collective *timing*
        # (applied by simulate's shared CollectiveModel / schedule
        # replay), never the distributed graph structure or any NodeRec
        # byte volume — so every placement of a factorization replays
        # the same lowered program
        return (tuple(sorted(cfg.axes)), cfg.dp_axis, cfg.tp_axis,
                cfg.cp_axis, cfg.ep_axis, cfg.sp, cfg.fsdp, cfg.zero1)

    def program(self, cfg: ParallelCfg) -> CostProgram:
        key = self._structure_key(cfg)
        with self._lock:
            for prog in self._classes.get(key, ()):
                if guards_match(prog.guards, cfg):
                    self.hits += 1
                    _metrics.counter("compiled.class_hits").inc()
                    return prog
            with _span("compiled.lower", axes=tuple(sorted(cfg.axes))):
                graph = self.build()
                with record_guards() as guards:
                    report = distribute(graph, cfg, self.env)
                prog = CostProgram(graph, self.env, n_layers=self.n_layers,
                                   guards=dict(guards), report=report)
            self._classes.setdefault(key, []).append(prog)
            self.compiles += 1
            _metrics.counter("compiled.class_compiles").inc()
            return prog

    def workload(self, cfg: ParallelCfg, name: str = "workload") -> Workload:
        return self.program(cfg).instantiate(cfg, name=name)

    def memory(self, cfg: ParallelCfg, **kw) -> MemoryReport:
        return self.program(cfg).peak_memory(cfg, **kw)

    def state_bytes(self, cfg: ParallelCfg, **kw) -> float:
        return self.program(cfg).state_bytes(cfg, **kw)

    def classes(self) -> dict:
        """Snapshot of the structure-class cache: structure key ->
        compiled :class:`CostProgram` list (compile order).  The static
        prover's partition pass checks every degree-lattice point
        against ALL programs sharing its key (exactly one guard set may
        match), so it needs the full per-key population, not just the
        dispatch winner."""
        with self._lock:
            return {k: list(v) for k, v in self._classes.items()}

    def stats(self) -> dict:
        with self._lock:
            return {"classes": sum(len(v) for v in self._classes.values()),
                    "compiles": self.compiles, "hits": self.hits}
