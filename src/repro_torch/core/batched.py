"""Batched evaluation backend: whole-sweep config replay on the card.

The compiled backend (repro_torch.core.compiled) replays one config at a
time in Python/numpy; a Fig-8-style sweep is thousands of structurally
identical replays that differ only in mesh degrees and microbatch
counts.  This module lowers each ``CostProgram`` structure class ONCE
MORE — from per-config numeric replay into dense tensors over a whole
*batch* of configs — and evaluates step time, bubble fraction, and peak
memory for the batch with eager PyTorch operations on one device
(the PyTorch port of ``repro.core.batched``, same lowering, same names):

* **Local sizes** — ``CostProgram.batch_tables`` turns the per-tensor
  partition patterns into a ``[nt, axes]`` exponent table, so the batch
  of local byte sizes is ``numel / prod(degs ** expo)`` — one
  integer-power gather for every config at once (the vectorized
  ``_local``, pinned against ``batch_bind``).
* **Node durations** — FLOP counts follow the same exponent-table trick
  (einsum letter axes collapse into summed exponents).  Every exponent
  table in the bundled archs is 0/1-valued, so the power products lower
  further into static *subset-product* gathers: all ``2^axes`` degree
  subset products are built once per batch and each table row reads one
  column (``_pow_plan`` / ``_subset_products`` — exact f64 integer
  arithmetic, no ``pow``).  The byte-access / memory-event selection
  tables are ~99% zeros, so they ship as COO triplets and reduce via
  ``index_add_`` (``_seg_reduce``); the dense busy-group contraction
  (``[B, entries] x [2 groups, entries]``, the compute and the comm rows
  in one table, one call per class call) goes through the hand-written
  kernel (:func:`repro_torch.kernels.ops.cost_reduce`, ``csrc/
  cost_reduce.cu`` on the card, its plain version on the CPU).
* **Two-stream scheduling** — the reference ``simulate._schedule`` list
  scheduler becomes one host loop over the flattened slot-group
  sequence, each step a few eager operations on ``[B]`` columns:
  dependencies resolve positionally *within* a group (each reference
  ``_schedule`` call starts a fresh ``finish`` dict, so cross-group deps
  are structurally zero), and group spans are read off the stream frees
  at static group-end positions.  Resets, dependencies and the stream of
  every step are static, so they are resolved on the host.
* **Pipeline replay** — gpipe / 1f1b / interleaved timelines are
  duration-independent DAGs, so the event order is planned once in
  Python and replayed as a second host loop (max-plus recurrence over
  per-(kind, chunk) spans).  ``zb-h1`` backfills weight-grads into
  duration-dependent gaps, so those configs fall back to the per-config
  compiled path (as do topology profiles and per-collective algorithm
  overrides, whose lowering depends on axis placement).
* **Memory** — the activation event sweep groups by unique event time;
  within a tie group the reference sorts deltas ascending, so every
  intermediate prefix sum is bounded by the two group-boundary sums and
  the batched peak (max over a cumulative sum of per-group signed
  count-matrix contractions) is exact up to float association.

Microbatch count is a *batched input* for pp = 1 (slot durations are
microbatch-independent; ``step = mb * span + opt``), so one kernel
covers the mb dimension of a sweep; pipelined groups key on
(schedule, mb) because the replay plan depends on both.

Numerics: results must match the compiled backend within rel 1e-6,
which requires float64 — the default dtype here, explicit in every
device constant.  The ``dtype`` hook exists so the regression test can
demonstrate float32 is NOT sufficient.  The two scans run eagerly as
Python loops of small launches; on CUDA, ``index_add_`` sums with
atomics, so results on the card agree with the CPU to float64 rounding,
not bit for bit.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..kernels.ops import cost_reduce
from ..obs import metrics as _metrics
from ..obs.log import get_logger
from ..obs.spans import span as _span
from .compiled import _PER_RANK_COLLS, _RING_COLLS, CompiledBackend, \
    CostProgram
from .distribute import ParallelCfg
from .memory import MemoryReport
from .schedules import FWD, _dep_key, build_schedule, inflight_factor
from .simulate import SimResult
from .tensor import DTYPE_BYTES

__all__ = ["BatchedBackend", "REPLAYABLE_SCHEDULES"]

_log = get_logger("core.batched")

# schedules whose replay order is duration-independent (zb-h1 backfills
# weight-grad slots into gaps whose existence depends on the durations)
REPLAYABLE_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def _hw_sig(hw) -> tuple:
    return (hw.peak_flops, hw.hbm_bw, hw.link_bw,
            tuple(sorted(hw.link_bw_axis.items())), hw.link_latency,
            tuple(sorted(hw.efficiency.items())))


def _coo(rows: list, cols: list, vals: list, ncols: int) -> tuple:
    """Row-major COO triplets (rows, cols, vals) of the selection table
    whose (row, col) cell is the sum of ``vals`` given there: what
    ``np.nonzero`` reads off the dense table, without building it (an
    [entries, tensors] table is ~20 M cells at full width, ~99% zeros)."""
    key = np.asarray(rows, np.int64) * ncols + np.asarray(cols, np.int64)
    cells, at = np.unique(key, return_inverse=True)
    summed = np.zeros(len(cells))
    np.add.at(summed, at, np.asarray(vals, np.float64))
    keep = summed != 0.0
    return cells[keep] // ncols, cells[keep] % ncols, summed[keep]


def _pow_plan(expo: np.ndarray) -> tuple:
    """Static lowering of a 0/1 exponent table to subset-product ids.

    Exponents are 0/1 in practice (a tensor is either sharded along an
    axis or not), so ``prod_a degs**expo[r, a]`` only takes one of the
    2^A axis-subset products — precompute the subset id per row and the
    evaluator gathers from a tiny [B, 2^A] product table instead of doing
    elementwise ``**``.  Returns ``(ids, None)``; tables with an exponent
    > 1 (not seen in any bundled arch) fall back to ``(None, expo_f64)``."""
    if expo.size and expo.max(initial=0) > 1:
        return None, np.asarray(expo, np.float64)
    ids = np.zeros(expo.shape[0], np.intp)
    for a in range(expo.shape[1]):
        ids |= (expo[:, a] > 0.5).astype(np.intp) << a
    return ids, None


def _pow_prod(degs, subs, plan):
    """``out[b, r] = prod_a degs[b, a] ** expo[r, a]`` via the
    :func:`_pow_plan` lowering: a [B, R] gather from the precomputed
    axis-subset products ``subs`` — exact f64 integer arithmetic."""
    ids, expo = plan
    if ids is not None:
        return subs[:, ids]
    return torch.prod(degs[:, None, :] ** expo[None], dim=2)


def _subset_products(degs):
    """All 2^A axis-subset products of the [B, A] degree columns."""
    cols = [torch.ones(degs.shape[0], dtype=degs.dtype, device=degs.device)]
    for a in range(degs.shape[1]):
        cols = cols + [c * degs[:, a] for c in cols]
    return torch.stack(cols, dim=1)                     # [B, 2^A]


def _seg_reduce(x, coo, nseg: int):
    """``out[b, r] = sum_nz vals[nz] * x[b, cols[nz]]`` over a COO
    table — the sparse counterpart of :func:`ops.cost_reduce` for the
    ~99%-sparse byte-access / memory-event selection tables, O(B*nnz)
    instead of the dense O(B*R*T): ``index_add_`` along the entry axis."""
    rows, cols, vals = coo
    out = torch.zeros((x.shape[0], nseg), dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return out
    return out.index_add_(1, rows, x[:, cols] * vals[None])


class _ClassKernel:
    """One batch evaluator for one (structure class, pipeline layout,
    schedule point, recompute) group of configs.

    Everything degree-independent is baked into device constants (in the
    evaluator's dtype, on its device) at construction; per-call inputs
    are the [B, axes] mesh degrees, the [B] microbatch counts (pp = 1
    only; static otherwise), and the hardware scalars/per-entry
    arrays."""

    def __init__(self, prog: CostProgram, axes: tuple, pp: int, vstages: int,
                 schedule: str, microbatches: int, recompute: bool,
                 dtype=None, device=None):
        self.prog = prog
        # pure-pipeline classes have no mesh axes; keep one dummy column
        # so the [B, axes] gathers/pow-products stay well-formed
        self.axes = axes = axes or ("_pad",)
        self.pp = pp = max(1, pp)
        self.vstages = vstages = max(1, vstages) if pp > 1 else 1
        self.schedule = schedule
        self.microbatches = microbatches
        self.recompute = recompute
        self.dtype = torch_dtype(dtype) if dtype is not None else torch.float64
        self.device = dev = resolve_device(device)
        A = len(axes)
        ax_ix = {a: j for j, a in enumerate(axes)}
        tabs = prog.batch_tables(axes)
        nt = len(tabs["numel"])
        lay = prog._layout(pp, vstages)
        entries = lay.entries
        E = len(entries)

        # ---- per-entry compute/comm coefficient tables -------------------
        fnum = np.zeros(E)
        fexp = np.zeros((E, A))
        s_ba: tuple = ([], [], [])                 # COO (entry, tensor, 1)
        c_kind = np.zeros(E, np.int32)          # 0 compute, 1 sendrecv, 2 coll
        c_src = np.zeros(E, np.intp)
        c_gb = np.zeros(E)
        c_ax = np.zeros(E, np.intp)
        c_oexp = np.zeros((E, A))
        c_perrank = np.zeros(E, bool)
        c_wmode = np.zeros(E, np.int32)         # 0 size, 1 (n-1)/n, 2 2(n-1)/n
        c_allred = np.zeros(E, bool)
        self._cats = [e[3] for e in entries]
        self._bw_axes: list[Optional[str]] = [None] * E
        for k, e in enumerate(entries):
            flop, ba_ix, cm = e[8], e[9], e[11]
            if flop is not None:
                if flop[0] == "scale":
                    fnum[k] = flop[1] * tabs["numel"][flop[2]]
                    fexp[k] = tabs["expo"][flop[2]]
                else:
                    f = 2.0
                    for fval, eaxes in prog._eins_f[flop[1]]:
                        f *= fval
                        for a in eaxes:
                            fexp[k, ax_ix[a]] += 1.0
                    fnum[k] = f
            for t in ba_ix:
                s_ba[0].append(k)
                s_ba[1].append(t)
                s_ba[2].append(1.0)
            if cm is None:
                continue
            if cm[0] == "SendRecv":
                c_kind[k] = 1
                c_src[k] = cm[1]
                self._bw_axes[k] = "pp"
            else:
                coll, axis, ref, other = cm
                c_kind[k] = 2
                c_gb[k] = tabs["gbytes"][ref]
                c_ax[k] = ax_ix[axis]
                for a in other:
                    c_oexp[k, ax_ix[a]] += 1.0
                c_perrank[k] = coll in _PER_RANK_COLLS
                c_allred[k] = coll == "AllReduce"
                if coll == "AllReduce":
                    c_wmode[k] = 2
                elif coll in _RING_COLLS or coll == "AllToAll":
                    c_wmode[k] = 1
                self._bw_axes[k] = axis

        # ---- slot groups (mirror simulate's per-_schedule-call scoping) --
        groups: list[list[int]] = []
        fmap: dict = {}
        bmap: dict = {}
        omap: dict = {}
        if pp <= 1:
            mbp = [k for k, e in enumerate(entries) if e[4] in ("fwd", "bwd")]
            if recompute:
                mbp += [k for k, e in enumerate(entries)
                        if e[4] == "fwd" and e[11] is None]
            groups.append(mbp)
            groups.append([k for k, e in enumerate(entries)
                           if e[4] == "opt"])
        else:
            for s in range(pp):
                fwd_c: dict = {}
                bwd_c: dict = {}
                opt: list = []
                for k, e in enumerate(entries):
                    if e[5] != s:
                        continue
                    if e[4] == "fwd":
                        fwd_c.setdefault(e[6], []).append(k)
                    elif e[4] == "bwd":
                        bwd_c.setdefault(e[6], []).append(k)
                    else:
                        opt.append(k)
                for c in sorted(set(fwd_c) | set(bwd_c)):
                    f = fwd_c.get(c, [])
                    b = bwd_c.get(c, [])
                    if recompute:
                        b = b + [k for k in f if entries[k][11] is None]
                    fmap[(s, c)] = len(groups)
                    groups.append(f)
                    bmap[(s, c)] = len(groups)
                    groups.append(b)
                omap[s] = len(groups)
                groups.append(opt)
        G = len(groups)

        # ---- flatten to one scan sequence with positional within-group
        #      deps (each reference _schedule call = fresh finish dict) ----
        seq_entry: list[int] = []
        seq_group: list[int] = []
        seq_reset: list[bool] = []
        seq_deps: list[list[int]] = []
        glast = np.full(G, -1, np.intp)
        for g, pos_list in enumerate(groups):
            uid_last: dict[int, int] = {}
            for j, k in enumerate(pos_list):
                e = entries[k]
                seq_deps.append([uid_last[d] for d in e[12] if d in uid_last])
                seq_entry.append(k)
                seq_group.append(g)
                seq_reset.append(j == 0)
                uid_last[e[0]] = len(seq_entry) - 1
                glast[g] = len(seq_entry) - 1
        K = len(seq_entry)
        is_comm = [entries[k][11] is not None for k in seq_entry]
        # busy-group rows, compute [:G] then comm [G:]: one table, so one
        # cost_reduce call per class call reduces both
        m_busy = np.zeros((2 * G, K))
        m_busy[np.asarray(seq_group) + G * np.asarray(is_comm, np.intp),
               np.arange(K)] = 1.0
        # the scan's static program: per step (reset, is_comm, deps), and
        # the group whose span is read off after each group-end step
        self._steps = list(zip(seq_reset, is_comm, seq_deps))
        self._span_at = {int(i): g for g, i in enumerate(glast) if i >= 0}

        # ---- pipeline replay plan (duration-independent event DAG) -------
        if pp > 1:
            sched = build_schedule(schedule, pp, microbatches, vstages)
            if sched.splits_backward:
                raise ValueError(
                    f"schedule {schedule!r} is not batch-replayable")
            ev_stage: list[int] = []
            ev_slot: list[int] = []         # group idx (G = zero-span slot)
            ev_dep: list[int] = []
            done: dict = {}
            ptr = [0] * pp
            remaining = sum(len(t) for t in sched.timelines)
            while remaining:
                progressed = False
                for s in range(pp):
                    tl = sched.timelines[s]
                    while ptr[s] < len(tl):
                        slot = tl[ptr[s]]
                        dep = _dep_key(slot, sched.chunks)
                        if dep is not None and dep not in done:
                            break
                        smap = fmap if slot.kind == FWD else bmap
                        ev_stage.append(s)
                        ev_slot.append(smap.get((s, slot.vstage), G))
                        ev_dep.append(done[dep] if dep is not None else -1)
                        key = ("f" if slot.kind == FWD else "b",
                               slot.mb, slot.vstage)
                        done[key] = len(ev_stage) - 1
                        ptr[s] += 1
                        remaining -= 1
                        progressed = True
                if not progressed:          # pragma: no cover - by design
                    raise RuntimeError(
                        f"schedule {schedule!r} replay plan deadlocked")
            self._ev = list(zip(ev_stage, ev_slot, ev_dep))
            # per-stage hosted (fwd+bwd) groups and opt group selectors
            sg = np.zeros((pp, G))
            og = np.zeros((pp, G))
            for (s, _c), g in fmap.items():
                sg[s, g] = 1.0
            for (s, _c), g in bmap.items():
                sg[s, g] = 1.0
            for s, g in omap.items():
                og[s, g] = 1.0
            self._sg, self._og = self._f(sg), self._f(og)
            self.inflight = inflight_factor(schedule, pp, microbatches,
                                            vstages, 0)
        else:
            self._ev = None
            self.inflight = inflight_factor(schedule or "1f1b", pp,
                                            microbatches, vstages, 0)

        # ---- memory lifetime tables (stage 0, peak_memory defaults) ------
        w_idx, upds, acts = prog._mem_static(pp, vstages, 0)
        s_w = np.zeros(nt)
        for t in w_idx:
            s_w[t] += 1.0
        self._n_upd = U = len(upds)
        u_m = np.zeros(U)
        u_g = np.zeros(U)
        u_sexp = np.zeros((U, A))
        u_gexp = np.zeros((U, A))
        gdb = DTYPE_BYTES["fp32"]
        wnumel = np.asarray(prog._wnumel)
        for u, (w_t, shard_axes, grad_axes) in enumerate(upds):
            u_m[u] = wnumel[w_t] * 4
            u_g[u] = wnumel[w_t] * gdb
            for a in shard_axes:
                u_sexp[u, ax_ix[a]] += 1.0
            for a in grad_axes:
                u_gexp[u, ax_ix[a]] += 1.0
        ev_times: dict = {}
        layer_rows: dict = {}
        for t, start, end, end_fwd, lyr, is_fused in acts:
            if is_fused or recompute:
                end = min(end, end_fwd)
            ev_times.setdefault(start, []).append((t, 1.0))
            ev_times.setdefault(end + 1, []).append((t, -1.0))
            if recompute and lyr is not None and not is_fused:
                layer_rows.setdefault(lyr, []).append(t)
        self._n_mev = Gm = len(ev_times)
        s_mem: tuple = ([], [], [])            # COO (event group, tensor, ±1)
        for g, time in enumerate(sorted(ev_times)):
            for t, sign in ev_times[time]:
                s_mem[0].append(g)
                s_mem[1].append(t)
                s_mem[2].append(sign)
        self._n_layer = L = len(layer_rows)
        s_layer: tuple = ([], [], [])          # COO (layer, tensor, 1)
        for r, lyr in enumerate(sorted(layer_rows)):
            for t in layer_rows[lyr]:
                s_layer[0].append(r)
                s_layer[1].append(t)
                s_layer[2].append(1.0)

        # static subset-product plans for the pow-product tables
        self._plans = {
            "expo": self._plan(tabs["expo"]), "fexp": self._plan(fexp),
            "c_oexp": self._plan(c_oexp), "u_sexp": self._plan(u_sexp),
            "u_gexp": self._plan(u_gexp),
        }

        # ---- device constants --------------------------------------------
        f, i = self._f, self._i
        # the selection tables are ~99% zeros (a handful of tensors per
        # entry / memory event), so they ship as COO triplets and reduce
        # via index_add_ instead of a dense [B,T]x[R,T] contraction
        coo = lambda m: tuple(                      # noqa: E731
            conv(a) for conv, a in zip((i, i, f), _coo(*m, nt)))
        self._c = {
            "numel": f(tabs["numel"]), "dbytes": f(tabs["dbytes"]),
            "fnum": f(fnum),
            "s_ba": coo(s_ba), "c_kind": i(c_kind),
            "c_src": i(c_src), "c_gb": f(c_gb),
            "c_ax": i(c_ax),
            "c_perrank": torch.as_tensor(c_perrank, device=dev),
            "c_wmode": i(c_wmode),
            # ring steps per peer: 2 (reduce-scatter + all-gather) for an
            # AllReduce, else 1
            "c_smul": f(np.where(c_allred, 2.0, 1.0)),
            "seq_entry": i(seq_entry),
            "m_busy": f(m_busy),
            "s_w": f(s_w), "u_m": f(u_m), "u_g": f(u_g),
            "s_mem": coo(s_mem), "s_layer": coo(s_layer),
        }
        self._K, self._G, self._E = K, G, E
        self._g_mb, self._g_opt = (0, 1) if pp <= 1 else (None, None)
        self._hw_cache: dict = {}

    def _f(self, a) -> torch.Tensor:
        """A host array as a device constant in the evaluator's dtype."""
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.device)

    def _i(self, a) -> torch.Tensor:
        """A host index array as an int64 device constant."""
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _plan(self, m) -> tuple:
        ids, expo = _pow_plan(np.asarray(m))
        return (self._i(ids) if ids is not None else None,
                self._f(expo) if expo is not None else None)

    # ---- per-profile entry arrays (cached per profile) -------------------
    def _hw_arrays(self, hw):
        sig = _hw_sig(hw)
        hit = self._hw_cache.get(sig)
        if hit is not None:
            return hit
        eff = hw.efficiency
        eff_e = np.asarray([eff.get(c, 0.9) for c in self._cats])
        bw_e = np.asarray([hw.link_bw_axis.get(a, hw.link_bw)
                           if a is not None else 1.0
                           for a in self._bw_axes])
        # device-resident, so a warm run() copies nothing per call
        out = tuple(self._f(v) for v in (eff_e, bw_e, hw.peak_flops,
                                         hw.hbm_bw, hw.link_latency))
        if len(self._hw_cache) > 8:
            self._hw_cache.clear()
        self._hw_cache[sig] = out
        return out

    # ---- the batch evaluator ---------------------------------------------
    def _scan(self, dur_bk):
        """The two-stream list scheduler over the flattened slot-group
        sequence, one step per entry, vectorised over B: returns the
        [G, B] group spans (max of the two streams' frees at each group's
        last step; 0 for an empty group).

        Every value is >= 0, so a step without dependencies starts at its
        stream's free time (the reference's ``max(0, free)``)."""
        B = dur_bk.shape[0]
        dur_seq = dur_bk.T                                  # [K, B] views
        zero = torch.zeros(B, dtype=self.dtype, device=self.device)
        spans = [zero] * self._G
        fin: list = []
        fc = fm = zero
        for i, (reset, comm, deps) in enumerate(self._steps):
            if reset:
                fc = fm = zero
            free = fm if comm else fc
            if deps:
                ready = fin[deps[0]]
                for d in deps[1:]:
                    ready = torch.maximum(ready, fin[d])
                free = torch.maximum(ready, free)
            end = free + dur_seq[i]
            if comm:
                fm = end
            else:
                fc = end
            fin.append(end)
            g = self._span_at.get(i)
            if g is not None:
                spans[g] = torch.maximum(fc, fm)
        return torch.stack(spans)                           # [G, B]

    def _replay(self, spans):
        """The pipeline replay: every planned event starts when its stage
        is free and its dependency has finished; returns the [B]
        makespan."""
        B = spans.shape[1]
        zero = torch.zeros(B, dtype=self.dtype, device=self.device)
        free = [zero] * self.pp
        fin: list = []
        for st, gi, di in self._ev:
            start = free[st] if di < 0 else torch.maximum(free[st], fin[di])
            end = start + spans[gi] if gi < self._G else start
            free[st] = end
            fin.append(end)
        return torch.stack(free).amax(dim=0)

    def _eval(self, degs, mbs, eff_e, bw_e, peak, hbm, lat):
        c = self._c
        B = degs.shape[0]
        dt = self.dtype
        zero = torch.zeros((), dtype=dt, device=self.device)

        # local sizes: the vectorized CostProgram._local
        subs = _subset_products(degs)                       # [B, 2^A]
        denom = _pow_prod(degs, subs, self._plans["expo"])
        ln = c["numel"][None] / denom                       # [B, nt]
        lb = ln * c["dbytes"][None]

        # per-entry durations
        fden = _pow_prod(degs, subs, self._plans["fexp"])
        flops = c["fnum"][None] / fden                      # [B, E]
        ba = _seg_reduce(lb, c["s_ba"], self._E)            # [B, E]
        t_flops = flops / (peak * eff_e[None])
        dur_comp = torch.maximum(t_flops, ba / hbm)
        n = degs[:, c["c_ax"]]                              # [B, E]
        odeg = _pow_prod(degs, subs, self._plans["c_oexp"])
        full = c["c_gb"][None] / odeg
        size = torch.where(c["c_perrank"][None], full, full / n)
        frac = (n - 1.0) / n
        wire = torch.where(c["c_wmode"][None] == 1, size * frac,
                           torch.where(c["c_wmode"][None] == 2,
                                       size * 2.0 * frac, size))
        steps = c["c_smul"][None] * (n - 1.0)
        dur_coll = torch.where(n > 1.0, wire / bw_e[None] + steps * lat, zero)
        dur_sr = lb[:, c["c_src"]] / bw_e[None] + lat
        dur = torch.where(c["c_kind"][None] == 0, dur_comp,
                          torch.where(c["c_kind"][None] == 1, dur_sr,
                                      dur_coll))

        # two-stream scan over the flattened slot-group sequence
        dur_bk = dur[:, c["seq_entry"]]                     # [B, K]
        with _span("batched.scan", steps=self._K):
            spans = self._scan(dur_bk)                      # [G, B]
        with _span("batched.cost_reduce"):
            busy = cost_reduce(dur_bk, c["m_busy"])         # [B, 2G]
        busy_c, busy_m = busy[:, :self._G], busy[:, self._G:]   # [B, G]

        if self.pp <= 1:
            gm, go = self._g_mb, self._g_opt
            span_mb, span_opt = spans[gm], spans[go]
            cb, ocb = busy_c[:, gm], busy_c[:, go]
            mb_, omb = busy_m[:, gm], busy_m[:, go]
            step = mbs * span_mb + span_opt
            compute = cb * mbs + ocb
            comm = mb_ * mbs + omb
            exposed = (torch.clamp_min(span_mb - cb, 0.0) * mbs
                       + torch.clamp_min(span_opt - ocb, 0.0))
            bubble = torch.zeros(B, dtype=dt, device=self.device)
        else:
            mb = float(self.microbatches)
            with _span("batched.replay", events=len(self._ev)):
                makespan = self._replay(spans)              # [B]
            o_span = self._og @ spans                       # [pp, B]
            t_opt = o_span.amax(dim=0)
            step = makespan + t_opt
            busy_rep = mb * (self._sg @ spans)              # [pp, B]
            tot = busy_rep.sum(dim=0)
            bubble = torch.where(makespan > 0.0,
                                 torch.clamp_min(1.0 - tot
                                                 / (makespan * self.pp), 0.0),
                                 zero)
            cb_s = busy_c @ self._sg.T                      # [B, pp]
            mb_s = busy_m @ self._sg.T
            exp_g = torch.clamp_min(spans.T - busy_c, 0.0)  # [B, G]
            exp_s = exp_g @ self._sg.T
            ocb_s = busy_c @ self._og.T
            omb_s = busy_m @ self._og.T
            osp_s = spans.T @ self._og.T
            oexp_s = torch.clamp_min(osp_s - ocb_s, 0.0)
            compute = (cb_s * mb + ocb_s).amax(dim=1)
            comm = (mb_s * mb + omb_s).amax(dim=1)
            exposed = (exp_s * mb + oexp_s).amax(dim=1)

        # memory (stage 0, peak_memory defaults: master fp32, fp32 grads)
        weights = lb @ c["s_w"]
        if self._n_upd:
            sdeg = _pow_prod(degs, subs, self._plans["u_sexp"])
            gdeg = _pow_prod(degs, subs, self._plans["u_gexp"])
            opt_states = (2.0 * c["u_m"][None] / sdeg).sum(dim=1)
            master = (c["u_m"][None] / sdeg).sum(dim=1)
            grads = (c["u_g"][None] / gdeg).sum(dim=1)
        else:
            opt_states = master = grads = torch.zeros(B, dtype=dt,
                                                      device=self.device)
        if self._n_mev:
            delta = _seg_reduce(lb, c["s_mem"], self._n_mev)   # [B, Gm]
            peak_act = torch.clamp_min(
                torch.cumsum(delta, dim=1).amax(dim=1), 0.0)
        else:
            peak_act = torch.zeros(B, dtype=dt, device=self.device)
        if self.recompute and self._n_layer:
            extra = _seg_reduce(lb, c["s_layer"],
                                self._n_layer).amax(dim=1)
        else:
            extra = torch.zeros(B, dtype=dt, device=self.device)

        return {"step": step, "compute": compute, "comm": comm,
                "exposed": exposed, "bubble": bubble, "weights": weights,
                "grads": grads, "opt_states": opt_states, "master": master,
                "peak_act": peak_act, "extra": extra}

    def run_async(self, degs: np.ndarray, mbs: np.ndarray, hw) -> dict:
        """Queue the evaluation on the device; values are device tensors —
        copying them to the host waits for them."""
        eff_e, bw_e, peak, hbm, lat = self._hw_arrays(hw)
        return self._eval(self._f(degs), self._f(mbs), eff_e, bw_e, peak,
                          hbm, lat)

    def run(self, degs: np.ndarray, mbs: np.ndarray, hw) -> dict:
        out = self.run_async(degs, mbs, hw)
        return {k: v.cpu().numpy() for k, v in out.items()}


class BatchedBackend:
    """Batched evaluator over a :class:`CompiledBackend`'s structure
    classes.  Thread-safe; kernels are cached per (program, pipeline
    layout, schedule point, recompute) group and reused across sweeps.

    ``device`` is the CUDA device unless the caller passes ``"cpu"``
    (:func:`repro_torch.resolve_device`: without a card and without that
    request this raises).  ``dtype`` overrides the evaluation precision
    (test hook — float32 demonstrably breaks the 1e-6 parity budget;
    leave as None for float64)."""

    def __init__(self, engine: CompiledBackend, *, dtype=None, device=None):
        self.engine = engine
        self.dtype = dtype
        self.device = resolve_device(device)
        self._kernels: dict = {}
        self._lock = threading.Lock()
        self.batch_sizes: list[int] = []
        self.points = 0

    def stats(self) -> dict:
        """Batch accounting for :meth:`SweepResult.summary`."""
        return {"kernels": len(self._kernels), "points": self.points,
                "batch_sizes": list(self.batch_sizes)}

    def _kernel(self, prog: CostProgram, axes: tuple, key: tuple
                ) -> _ClassKernel:
        with self._lock:
            kern = self._kernels.get(key)
            if kern is None:
                _, pp, vstages, schedule, mb, recompute = key
                with _span("batched.kernel_build", pp=pp,
                           schedule=schedule or ""):
                    kern = _ClassKernel(prog, axes, pp, vstages,
                                        schedule or "1f1b", mb, recompute,
                                        dtype=self.dtype, device=self.device)
                self._kernels[key] = kern
                _metrics.counter("batched.kernel_builds").inc()
            return kern

    def supports(self, cfg: ParallelCfg, hw, algorithms=None) -> bool:
        """Whether (cfg, hw) evaluates natively: flat profiles without
        per-collective algorithm overrides, any non-zb schedule.
        Everything else lowers placement-dependently -> compiled path."""
        if getattr(hw, "topology", None) is not None or algorithms:
            return False
        return max(1, cfg.pp) <= 1 or cfg.schedule in REPLAYABLE_SCHEDULES

    def evaluate_many(self, cfgs: list, hw, *, recompute: bool = False
                      ) -> list:
        """Evaluate a batch of configs; returns a list aligned with
        ``cfgs`` of ``(SimResult, MemoryReport)`` tuples, with ``None``
        for configs that must fall back to the per-config compiled path
        (unsupported schedule / profile, or structure-class lowering
        failure — the fallback re-raises the real error per config)."""
        out: list = [None] * len(cfgs)
        if getattr(hw, "topology", None) is not None:
            _log.debug("profile %s has a topology: all %d cfgs fall back "
                       "to the compiled path", getattr(hw, "name", "?"),
                       len(cfgs))
            _metrics.counter("batched.fallback_topology").inc(len(cfgs))
            return out
        buckets: dict = {}
        sched_skips = 0
        with _span("batched.evaluate_many", cfgs=len(cfgs)):
            for i, cfg in enumerate(cfgs):
                pp = max(1, cfg.pp)
                if pp > 1 and cfg.schedule not in REPLAYABLE_SCHEDULES:
                    sched_skips += 1
                    continue
                try:
                    prog = self.engine.program(cfg)
                except Exception as e:
                    # per-config path reports it
                    _log.debug("cfg %d (%s): lowering failed (%s: %s) -> "
                               "compiled fallback", i, cfg.axes,
                               type(e).__name__, e)
                    _metrics.counter("batched.fallback_lowering").inc()
                    continue
                vstages = max(1, getattr(cfg, "vstages", 1)) if pp > 1 else 1
                key = (id(prog), pp, vstages,
                       cfg.schedule if pp > 1 else "",
                       cfg.microbatches if pp > 1 else 0, recompute)
                buckets.setdefault(key, (prog, []))[1].append(i)
            if sched_skips:
                _log.debug("%d cfgs on non-replayable schedules (zb-h1) "
                           "-> compiled fallback", sched_skips)
                _metrics.counter("batched.fallback_schedule").inc(sched_skips)
            # queue every bucket before harvesting any: the device works
            # through class call i while the host issues class call i+1
            pend = []
            for key, (prog, idxs) in buckets.items():
                axes = tuple(sorted(cfgs[idxs[0]].axes))
                kern = self._kernel(prog, axes, key)
                with _span("batched.class_call", points=len(idxs),
                           pp=kern.pp):
                    res = self._dispatch(kern, cfgs, idxs, hw)
                pend.append((kern, idxs, res))
                self.batch_sizes.append(len(idxs))
                self.points += len(idxs)
                _metrics.counter("batched.kernel_calls").inc()
                _metrics.histogram("batched.batch_size").observe(len(idxs))
            for kern, idxs, res in pend:
                self._harvest(kern, cfgs, idxs, res, out)
        return out

    def _dispatch(self, kern: _ClassKernel, cfgs: list, idxs: list, hw
                  ) -> dict:
        degs = np.ones((len(idxs), len(kern.axes)))
        mbs = np.ones(len(idxs))
        for j, i in enumerate(idxs):
            cfg = cfgs[i]
            degs[j] = [cfg.axes.get(a, 1) for a in kern.axes]
            mbs[j] = cfg.microbatches
        return kern.run_async(degs, mbs, hw)

    def _harvest(self, kern: _ClassKernel, cfgs: list, idxs: list,
                 res: dict, out: list) -> None:
        col = {k: v.cpu().tolist() for k, v in res.items()}
        for j, i in enumerate(idxs):            # bulk, not 18*B float()
            cfg = cfgs[i]
            comm = col["comm"][j]
            exposed = col["exposed"][j]
            hidden = max(0.0, comm - exposed)
            sim = SimResult(
                step_time=col["step"][j],
                compute_time=col["compute"][j],
                comm_time=comm, exposed_comm=exposed,
                overlap_ratio=(hidden / comm) if comm > 0 else 1.0,
                bubble_fraction=col["bubble"][j],
                schedule=getattr(cfg, "schedule", "1f1b"), stages=[])
            mem = MemoryReport(
                weights=col["weights"][j],
                grads=col["grads"][j],
                opt_states=col["opt_states"][j],
                master_params=col["master"][j],
                peak_activation=col["peak_act"][j],
                inflight_factor=kern.inflight,
                recompute_extra=col["extra"][j])
            out[i] = (sim, mem)
