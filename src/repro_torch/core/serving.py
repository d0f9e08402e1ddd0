"""Phase-program evaluation: closed-form decode timelines (tentpole of
the serving redesign).

A generation request is a *phase program*: one prefill phase followed by
hundreds of decode steps against a KV cache that grows by one entry per
step.  Naively that is one full engine evaluation per decode index —
each step binds a different ``Skv``, so every step would pay a fresh
coefficient binding (and, through the engine cache, a fresh lowering).
:class:`DecodeSeries` instead lowers the decode structure ONCE and
treats the bound coefficients as *polynomials of the decode index*:

* **One lowering.**  ``distribute`` + :class:`~repro_torch.core.compiled.CostProgram`
  run once at the starting KV length; a second ``distribute`` at the
  final KV length verifies the recorded divisibility guards are stable
  across the range (a KV-dependent sharding that flips mid-generation
  has no single closed form and raises).
* **Polynomial coefficients.**  Every coefficient expression is expanded
  under ``Skv -> kv0 + t`` (and the sliding-window extent ``WN ->
  min(window, kv0 + t)``, which splits the range into at most two affine
  segments at the window boundary) into an exact polynomial in the
  decode index ``t``; re-binding the program for any step is a matrix
  multiply, not a sympy pass.
* **Closed-form sum.**  A decode step's simulated time is built from
  ``+``/``max`` over affine functions of ``t``, hence convex
  piecewise-linear in ``t`` — :func:`~repro_torch.core.simulate.sum_convex_series`
  sums it exactly on linear stretches (3 evaluations for a fully linear
  512-step generation) and only subdivides at genuine breakpoints.
* **Bit-identical spot checks.**  :meth:`DecodeSeries.step_workload`
  re-binds with *exactly* evaluated coefficients through the same
  ``_evaluate_exprs`` entry point a fresh ``CostProgram`` would use, so
  any individual decode index replays bit-identically to the reference
  per-step sympy pipeline (tests/test_serving.py pins this with ``==``).

:class:`PhaseResult` / :class:`JobResult` are the end-to-end serving
metrics (TTFT / TPOT / tokens/s / KV-transfer) assembled by
:meth:`repro_torch.api.Job.evaluate`.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import sympy as sp

from .assemble import ModelSpec, bind_env, total_layers
from .collectives import CollectiveModel, comm_model
from .compiled import CostProgram, _evaluate_exprs, _prod_degrees
from .costmodel import HardwareProfile
from .distribute import ParallelCfg, distribute, record_guards
from .instantiate import Workload
from .matcher import InfeasibleConfigError
from .memory import MemoryReport
from .simulate import SimResult, simulate, sum_convex_series
from .symbolic import Env

__all__ = ["DecodeSeries", "PhaseResult", "JobResult"]


class DecodeSeries:
    """Closed-form cost of ``steps`` decode steps with a growing KV cache.

    ``build`` must return a fresh mutable :class:`~repro_torch.core.stg.Graph`
    per call (it is called twice: the lowered structure and the
    guard-stability check at the far end of the range).  Step ``t``
    models one token for the whole batch against a cache of
    ``kv0 + t`` entries.
    """

    def __init__(self, build, spec: ModelSpec, cfg: ParallelCfg, *,
                 batch: int, kv0: int, steps: int, name: str = "decode"):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if kv0 < 1:
            raise ValueError(f"kv0 must be >= 1, got {kv0}")
        self.spec, self.cfg = spec, cfg
        self.batch, self.kv0, self.steps = batch, kv0, steps
        self.name = name
        env0 = self.env_at(0)
        graph = build()
        with record_guards() as guards:
            report = distribute(graph, cfg, env0)
        self._prog = CostProgram(graph, env0, n_layers=total_layers(spec),
                                 guards=dict(guards), report=report)
        self.engine_calls = 1            # lowerings (the O(1) guarantee)
        self._check_guard_stability(build)
        self._segments = self._build_segments()
        self._bound: Optional[tuple] = ("exact", 0)   # program bind state
        # binding mutates the shared CostProgram in place; the lock makes
        # each bind→instantiate/peak_memory section atomic so a series
        # handed out by the process-wide cache is safe under concurrent
        # Job evaluation (the materialized workloads themselves are
        # per-thread scratch / fresh objects)
        self._lock = threading.Lock()
        # KV roots: non-weight graph inputs whose size grows with the
        # decode index (k/v caches; MLA latent + rope caches)
        coeffs0 = self._segments[0][2]
        self._kv_roots = []
        for i in sorted(self._prog._roots):
            if self._prog._tkind[i] == "weight":
                continue
            c = coeffs0[self._prog._t_ci[i]]
            if len(c) > 1 and any(ck != 0 for ck in c[1:]):
                self._kv_roots.append(i)

    # ---- environment / segmentation -------------------------------------
    def env_at(self, t: int) -> Env:
        """The reference Env a per-step sympy replay of index ``t`` binds."""
        return bind_env(self.spec, batch=self.batch, seq=1,
                        kv_len=self.kv0 + t, mode="decode")

    def _check_guard_stability(self, build) -> None:
        """A guard whose outcome depends on Skv flips somewhere inside
        the range — the structure class then changes mid-generation and
        no single lowered program covers it."""
        if self.steps == 1:
            return
        env_n = self.env_at(self.steps - 1)
        with record_guards() as guards_n:
            distribute(build(), self.cfg, env_n)
        self.engine_calls += 1
        if dict(guards_n) != self._prog.guards:
            raise InfeasibleConfigError(
                f"KV-dependent sharding changes across decode range "
                f"[{self.kv0}, {self.kv0 + self.steps - 1}] "
                f"(guards {self._prog.guards} vs {dict(guards_n)}); "
                f"split the generation at the boundary or drop the "
                f"KV-length sharding")

    def _build_segments(self) -> list:
        """``(t_lo, t_hi, exact coeff tuples, float coeff matrix)`` per
        affine stretch of the env symbols (at most two: the sliding
        window clamps ``WN`` once the cache outgrows it)."""
        bounds = [0, self.steps]
        w = self.spec.window
        if w is not None and self.kv0 < w <= self.kv0 + self.steps - 1:
            bounds = [0, w - self.kv0, self.steps]
        segs = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            coeffs = self._extract_polys(lo)
            deg = max(len(c) for c in coeffs)
            mat = np.zeros((len(coeffs), deg), dtype=np.float64)
            for i, c in enumerate(coeffs):
                for k, ck in enumerate(c):
                    mat[i, k] = float(ck)
            segs.append((lo, hi - 1, coeffs, mat))
        return segs

    def _extract_polys(self, t_ref: int) -> list:
        """Exact ascending coefficient tuples of every coefficient
        expression as a polynomial in the decode index ``t``, valid on
        the affine segment containing ``t_ref``."""
        tau = sp.Symbol("_t_dec", integer=True, nonnegative=True)
        env_a = self.env_at(t_ref)
        env_b = self.env_at(t_ref + 1) if self.steps > t_ref + 1 else env_a
        sub = {}
        for s, v in env_a.items():
            slope = env_b.get(s, v) - v
            if slope == 0:
                sub[s] = sp.sympify(v)
            else:
                # affine-in-t binding: v + slope * (t - t_ref)
                sub[s] = sp.sympify(v - slope * t_ref) + slope * tau
        out = []
        for expr in self._prog._exprs:
            p = sp.expand(sp.sympify(expr).xreplace(sub))
            if not p.has(tau):
                out.append((sp.nsimplify(p),))
                continue
            out.append(tuple(reversed(sp.Poly(p, tau).all_coeffs())))
        return out

    def _segment(self, t: int) -> tuple:
        for seg in self._segments:
            if seg[0] <= t <= seg[1]:
                return seg
        raise IndexError(f"decode index {t} outside [0, {self.steps - 1}]")

    def _seg_coeffs_exact(self, t: int) -> list:
        return self._segment(t)[2]

    # ---- program binding -------------------------------------------------
    def _bind_fast(self, t: int) -> None:
        """Float polynomial binding: a matvec over the coefficient
        matrix (the closed-form sampling path)."""
        if self._bound == ("fast", t):
            return
        _, _, _, mat = self._segment(t)
        powers = np.power(float(t), np.arange(mat.shape[1]))
        self._prog.bind_vals((mat @ powers).tolist())
        self._bound = ("fast", t)

    def _bind_exact(self, t: int) -> None:
        """Exact binding through the same ``_evaluate_exprs`` entry point
        a fresh :class:`CostProgram` under ``env_at(t)`` would use — the
        bit-identical spot-check path."""
        if self._bound == ("exact", t):
            return
        self._prog.bind_vals(_evaluate_exprs(self._prog._exprs,
                                             self.env_at(t)))
        self._bound = ("exact", t)

    # ---- per-step evaluation ---------------------------------------------
    def step_workload(self, t: int, *, name: Optional[str] = None) -> Workload:
        """The decode-index-``t`` workload, bit-identical to the full
        per-step pipeline replay under ``env_at(t)``."""
        with self._lock:
            self._bind_exact(t)
            return self._prog.instantiate(
                self.cfg, name=name or f"{self.name}/t{t}")

    def step_sim(self, t: int, hw: HardwareProfile, *,
                 model: Optional[CollectiveModel] = None,
                 algorithms: Optional[dict] = None,
                 exact: bool = False) -> SimResult:
        """Simulated step time at decode index ``t``; ``algorithms``
        forces collective algorithms exactly as in :func:`simulate`
        (ignored when a pre-built ``model`` is supplied)."""
        with self._lock:
            if exact:
                self._bind_exact(t)
            else:
                self._bind_fast(t)
            w = self._prog.instantiate(self.cfg, reuse=True)
            return simulate(w, hw, model=model, algorithms=algorithms)

    def step_memory(self, t: int, *, exact: bool = True,
                    **kw) -> MemoryReport:
        """Peak-memory report at decode index ``t`` (weights +
        activation lifetimes; the KV cache itself is reported separately
        by :meth:`kv_bytes` — it is workload state, not graph-produced)."""
        with self._lock:
            if exact:
                self._bind_exact(t)
            else:
                self._bind_fast(t)
            return self._prog.peak_memory(self.cfg, **kw)

    # ---- closed-form totals ----------------------------------------------
    def total_time(self, hw: HardwareProfile, *,
                   steps: Optional[int] = None,
                   algorithms: Optional[dict] = None,
                   rel_tol: float = 1e-9,
                   seed: Optional[dict] = None) -> tuple[float, int]:
        """``(sum of step times over the range, evaluations used)``.

        Exact on linear stretches (arithmetic series over the integer
        decode indices); convexity of the step time in ``t`` pins the
        subdivision test (see :func:`~repro_torch.core.simulate.sum_convex_series`).
        ``steps`` clips to a prefix of the lowered range, so one series
        serves every ``out_tokens`` value of a sweep up to its size;
        ``seed`` passes step times the caller already simulated
        (``{t: step_time}``) so e.g. the endpoint sims a
        :class:`~repro_torch.api.Job` reports are not evaluated twice."""
        last = (self.steps if steps is None else min(steps, self.steps)) - 1
        model = comm_model(hw, self.cfg, algorithms)
        total, evals = 0.0, 0
        for lo, hi, _, _ in self._segments:
            if lo > last:
                break
            s, n = sum_convex_series(
                lambda t: self.step_sim(t, hw, model=model).step_time,
                lo, min(hi, last), rel_tol=rel_tol, seed=seed)
            total += s
            evals += n
        return total, evals

    # ---- KV cache accounting ----------------------------------------------
    def kv_bytes(self, t: int, *, local: bool = False) -> float:
        """Bytes of KV-cache state read at decode index ``t``: the root
        inputs whose size grows with the decode index.  Global by
        default (the pool-handoff quantity — invariant under sharding
        and placement); ``local=True`` is one rank's shard — mesh-axis
        sharding applied per tensor, and an even per-stage layer split
        for ``pp > 1`` (each pipeline rank holds only its own layers'
        caches)."""
        prog = self._prog
        coeffs = self._seg_coeffs_exact(t)
        total = 0.0
        for i in self._kv_roots:
            c = coeffs[prog._t_ci[i]]
            val = sum(ck * t ** k for k, ck in enumerate(c))
            b = float(val * prog._t_db[i])
            if local:
                b /= _prod_degrees(self.cfg.axes, prog._t_part[i])
            total += b
        if local:
            total /= max(1, self.cfg.pp)
        return total

    def stats(self) -> dict:
        return {"engine_calls": self.engine_calls,
                "segments": len(self._segments), "steps": self.steps}


# --------------------------------------------------------------------------
# End-to-end serving metrics
# --------------------------------------------------------------------------

@dataclass
class PhaseResult:
    """One evaluated phase of a :class:`repro_torch.api.Job`."""
    name: str
    pool: str
    mode: str                    # train | prefill | decode
    steps: int
    time: float                  # seconds for the whole phase
    step_first: float            # simulated time of the first step
    step_last: float             # ... and the last (growth visible here)
    evals: int                   # simulator evaluations consumed
    peak_gb: float               # per-rank HBM high-water incl. KV shard
    kv_bytes_end: float = 0.0    # GLOBAL KV-cache bytes after the phase
    world: int = 1
    sim: Optional[SimResult] = None        # representative (last) step
    workload: Optional[Workload] = None    # representative step (chakra)

    def row(self) -> dict:
        return {"phase": self.name, "pool": self.pool, "steps": self.steps,
                "time_ms": round(self.time * 1e3, 3),
                "step_ms": round(self.step_last * 1e3, 4),
                "peak_gb": round(self.peak_gb, 2)}


@dataclass
class JobResult:
    """End-to-end metrics of one serving job (request timeline).

    ``ttft`` — time to first token: the prefill phase (plus, for
    disaggregated pools, nothing: the KV transfer overlaps the first
    token's network return in this model, but it DOES delay the second
    token and is charged to ``total_time``).  ``tpot`` — mean time per
    output token over the decode steps.  ``tokens_per_s`` — aggregate
    decode+prefill token throughput of the whole job."""
    phases: list[PhaseResult]
    batch: int
    out_tokens: int
    ttft: float
    tpot: float
    total_time: float
    kv_transfer_bytes: float = 0.0
    kv_transfer_time: float = 0.0
    disaggregated: bool = False
    engine_evals: dict = field(default_factory=dict)
    label: str = ""

    @property
    def tokens_per_s(self) -> float:
        """Aggregate generated-token throughput (whole batch)."""
        return self.batch * self.out_tokens / self.total_time \
            if self.total_time > 0 else 0.0

    @property
    def decode_time(self) -> float:
        return sum(p.time for p in self.phases if p.mode == "decode")

    @property
    def peak_gb(self) -> float:
        return max((p.peak_gb for p in self.phases), default=0.0)

    @property
    def peak_kv_gb(self) -> float:
        """Global KV-cache high-water across the timeline (GB)."""
        return max((p.kv_bytes_end for p in self.phases), default=0.0) / 2**30

    def row(self) -> dict:
        return {"label": self.label, "batch": self.batch,
                "out_tokens": self.out_tokens,
                "ttft_ms": round(self.ttft * 1e3, 3),
                "tpot_ms": round(self.tpot * 1e3, 4),
                "tokens_per_s": round(self.tokens_per_s, 1),
                "peak_gb": round(self.peak_gb, 2),
                "peak_kv_gb": round(self.peak_kv_gb, 3),
                **({"kv_transfer_ms":
                    round(self.kv_transfer_time * 1e3, 3)}
                   if self.disaggregated else {})}

    def describe(self) -> str:
        r = self.row()
        bits = [f"b={self.batch} out={self.out_tokens}",
                f"TTFT {r['ttft_ms']}ms", f"TPOT {r['tpot_ms']}ms",
                f"{r['tokens_per_s']} tok/s"]
        if self.disaggregated:
            bits.append(f"kv-xfer {r['kv_transfer_ms']}ms "
                        f"({self.kv_transfer_bytes / 2**20:.1f}MiB)")
        return ", ".join(bits)
