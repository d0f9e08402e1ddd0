"""Symbolic invariant prover: certify whole DSE spaces, not single traces.

The compiled backend lowers each *structure class* — one distributed
graph shape, shared by every config with the same guard outcomes — to
flat coefficient tables whose entries are polynomial in the workload
shape and whose per-config evaluation divides by mesh-degree monomials
(``repro_torch.core.compiled``).  The paper-level invariants are therefore
*polynomial identities in the config symbols*, provable once per class
and thereby for every config the class covers — millions at a time —
without instantiating or simulating anything.  The passes (rule family
``STG6xx``):

``STG601`` **FLOP conservation.**  Per node, the world-summed
    distributed FLOPs are ``local * prod(deg_a)``; with the lowered
    recipe ``local = c / prod(deg_a ** k_a)`` that is
    ``c * prod(deg_a ** (1 - k_a))``.  The pass checks, per node name,
    that the exact coefficient ``c`` (an integer — the tables are bound
    over exact ints) equals the single-device program's and that every
    shard exponent ``k_a`` is 0 or 1 — i.e. the total is the
    single-device total times a *replication monomial* with exponents
    in {0, 1} (replicated norm-bwd under cp, loss/embedding-grad under
    tp, optimizer updates under plain dp).  Since both backends repeat
    fwd/bwd nodes ``mb`` times and opt nodes once, the per-node
    identity lifts to the full ``mb`` polynomial.

``STG602`` **Comm-volume conservation.**  Every collective's wire-byte
    formula (:func:`repro_torch.core.compiled.collective_wire`) must match
    the independent ring-term invariant table of
    :mod:`repro_torch.analysis.comm_checks` as an exact symbolic identity in
    the message size (checked with a sympy size symbol at every group
    degree the lattice reaches), and each comm node's residual-shard
    divisor must equal its reference tensor's partition minus the
    collective axis.

``STG603``/``STG604`` **Guard completeness & disjointness.**  Guards
    depend on a config only through its axis degrees
    (:func:`repro_torch.core.distribute.guards_match_degrees`), so the
    microbatch/schedule/placement dimensions collapse and the *degree
    lattice* of a space is tiny (tens of points for a 10^5-config
    world).  The pass probes each lattice point once, then checks that
    exactly one class's guard set matches every point (STG603) and that
    each class's recorded guards reproduce verbatim under a fresh
    distribution trace (STG604 — catches deleted, duplicated, or
    flipped guard entries that the partition check alone could miss).

``STG605`` **Bound soundness.**  The branch-and-bound step floor
    ``max(mb * M, path) + O`` is re-derived here from the frozen layout
    entries and exact tables — independently of
    :func:`repro_torch.core.dse._cell_floor` — and the two must agree at
    every (degrees, pp, vstages) cell of the space; the zb-h1 path
    exclusion of :func:`repro_torch.core.dse.step_lower_bound` is checked
    behaviorally.  Together these certify that ``search="bnb"`` prunes
    only with the documented sound bound, i.e. returns the exact front.

``STG606`` **Memory monotonicity.**  Peak memory is a sum of terms
    ``bytes / prod(deg_a ** k_a)`` over a degree-independent event
    structure, so it is non-increasing in every mesh degree iff all
    partition exponents are >= 0 and all volumes >= 0 — checked
    statically, then spot-confirmed on comparable lattice pairs.
    Certified classes let :func:`repro_torch.core.dse.branch_and_bound` prune
    provably-dominated candidates before evaluating the memory model.

Entry points: :func:`prove_space` (engine-level),
:meth:`repro_torch.api.Scenario.prove`, ``dse.sweep(prove=True)``, and
``python -m repro_torch.analysis --prove``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import Optional

import sympy as sp

from ..core import compiled as _compiled
from ..core import dse as _dse
from ..core.compiled import CompiledBackend, CostProgram
from ..core.costmodel import TPU_V5E, HardwareProfile
from ..core.distribute import (ParallelCfg, distribute, guards_match_degrees,
                               record_guards)
from ..core.matcher import InfeasibleConfigError
from .diagnostics import (BOUND_UNSOUND, CLASS_OVERLAP, COMM_NOT_CONSERVED,
                          FLOP_NOT_CONSERVED, GUARD_UNFAITHFUL,
                          INFEASIBLE_CONFIG, MEM_NOT_MONOTONE, Report)

_KNOWN_COLLS = (set(_compiled._PER_RANK_COLLS) | set(_compiled._RING_COLLS)
                | {"AllToAll", "SendRecv"})
_REL = 1e-9


# --------------------------------------------------------------------------
# Certificates
# --------------------------------------------------------------------------

@dataclass
class ClassCertificate:
    """What was proved for one structure class (one ``CostProgram``)."""
    label: str                       # axes/flags description
    axes: tuple                      # mesh axis names (sorted)
    degrees: tuple                   # lattice degree tuples the class covers
    flop_conserved: bool = False
    comm_conserved: bool = False
    guards_faithful: bool = False
    bound_sound: bool = False
    mem_monotone: bool = False
    program: Optional[CostProgram] = field(default=None, repr=False,
                                           compare=False)

    @property
    def ok(self) -> bool:
        return (self.flop_conserved and self.comm_conserved
                and self.guards_faithful and self.bound_sound
                and self.mem_monotone)


@dataclass
class SpaceCertificate:
    """One :func:`prove_space` run: per-class certificates plus the
    space-wide partition verdict and the diagnostics that broke any
    proof.  ``ok`` means every invariant held for every class — the
    whole config space is certified."""
    name: str
    report: Report
    classes: list
    partition_ok: bool
    configs: int                     # concrete configs the space holds
    lattice_points: int
    # in-flight activation factor non-decreasing in microbatches for
    # every (schedule, pp, vstages) the space sweeps — lets the search
    # reuse a smaller-mb memory value as a lower bound for a larger-mb
    # candidate of the same cell (degree-independent, proved globally)
    inflight_monotone: bool = False              # degree-lattice points probed

    @property
    def ok(self) -> bool:
        return self.report.ok and self.partition_ok \
            and all(c.ok for c in self.classes)

    def memory_monotone_programs(self) -> frozenset:
        """ids of programs whose memory-monotonicity certificate holds —
        the set :func:`repro_torch.core.dse.branch_and_bound` consults for
        certificate-driven pruning."""
        return frozenset(id(c.program) for c in self.classes
                         if c.mem_monotone and c.program is not None)

    def summary(self) -> str:
        head = (f"{len(self.classes)} class(es), "
                f"{self.lattice_points} lattice point(s), "
                f"{self.configs} config(s)")
        if self.ok:
            return head + ": all invariants certified"
        return head + (f": {len(self.report.errors)} violation(s) — see "
                       f"certificate report")

    def render(self) -> str:
        return f"prove {self.name}: {self.summary()}\n" + self.report.render()


# --------------------------------------------------------------------------
# STG601 — FLOP conservation
# --------------------------------------------------------------------------

def _flop_totals(info: dict) -> tuple[dict, list]:
    """Aggregate exact world-monomial FLOP totals per node name:
    ``name -> [sum of exact coefficients, shard-exponent dict]``.  The
    coefficient is the node's FLOPs times ``prod(deg ** k)`` — i.e. the
    world-summed total is ``coeff * prod(deg_a ** (1 - k_a))``."""
    out: dict = {}
    bad: list = []
    part, numel, eins = info["part"], info["numel"], info["eins"]
    for i, p in enumerate(info["nodes"]):
        f = p.flop
        if f is None:
            continue
        if f[0] == "scale":
            coeff = Fraction(f[1]) * Fraction(numel[f[2]])
            exps = {a: int(k) for a, k in part[f[2]]}
        else:                                   # einsum letter products
            coeff = Fraction(2)
            exps = {}
            for fval, axes in eins[i]:
                coeff *= Fraction(fval)
                for a in axes:
                    exps[a] = exps.get(a, 0) + 1
        exps = {a: k for a, k in exps.items() if k}
        prev = out.get(p.name)
        if prev is None:
            out[p.name] = [coeff, exps]
        elif prev[1] != exps:
            bad.append(p.name)
        else:
            prev[0] += coeff
    return out, bad


def _check_flops(rep: Report, info: dict, totals0: dict, label: str) -> bool:
    totals, bad = _flop_totals(info)
    ok = True
    for name in bad:
        rep.add(FLOP_NOT_CONSERVED,
                f"{label}: copies of node {name!r} disagree on shard "
                f"exponents — total is not a single monomial", node=name)
        ok = False
    for name, (coeff, exps) in totals.items():
        ref = totals0.get(name)
        if ref is None:
            rep.add(FLOP_NOT_CONSERVED,
                    f"{label}: distributed node {name!r} has no "
                    f"single-device counterpart", node=name)
            ok = False
            continue
        if coeff != ref[0]:
            rep.add(FLOP_NOT_CONSERVED,
                    f"{label}: node {name!r} world-summed coefficient "
                    f"{coeff} != single-device {ref[0]}", node=name)
            ok = False
        for a, k in exps.items():
            if k not in (0, 1):
                rep.add(FLOP_NOT_CONSERVED,
                        f"{label}: node {name!r} shard exponent {k} on "
                        f"axis {a!r} leaves replication exponent "
                        f"{1 - k} outside {{0, 1}}", node=name)
                ok = False
    for name in totals0:
        if name not in totals:
            rep.add(FLOP_NOT_CONSERVED,
                    f"{label}: single-device node {name!r} lost in "
                    f"distribution", node=name)
            ok = False
    rep.tally("prove.flop_nodes", len(totals))
    return ok


# --------------------------------------------------------------------------
# STG602 — comm-volume conservation
# --------------------------------------------------------------------------

def _reference_wire(coll: str, size, n: int):
    """Independent ring-invariant table (mirrors
    :func:`repro_torch.analysis.comm_checks._expected_wire`, which the STG1xx
    per-trace pass applies numerically)."""
    from .comm_checks import _expected_wire
    return _expected_wire(coll, size, n)


def _reference_steps(coll: str, n: int) -> int:
    # ring algorithms: reduce-scatter + all-gather phases for AllReduce,
    # a single ring pass for the shard collectives
    return 2 * (n - 1) if coll == "AllReduce" else n - 1


def _group_sizes(covered) -> list:
    """Every collective group size the class can instantiate: each axis
    degree of each covered lattice point, plus products of degrees
    within one point (flattened multi-axis groups, e.g. fsdp over
    dp×cp).  Sound and tiny — a pow-2 space reaches ~log2(world) sizes,
    not world of them."""
    out: set = set()
    for degs in covered:
        sizes = {1}
        for d in degs:
            sizes |= {s * d for s in sizes}
        out |= sizes
    out.discard(1)
    return sorted(out)


def _check_comm(rep: Report, info: dict, sizes: list, label: str) -> bool:
    ok = True
    used: dict = {}
    part = info["part"]
    for p in info["nodes"]:
        if p.comm is None:
            continue
        coll, axis, ref, other = p.comm
        used.setdefault(coll, p.name)
        if coll not in _KNOWN_COLLS:
            rep.add(COMM_NOT_CONSERVED,
                    f"{label}: node {p.name!r} uses unknown collective "
                    f"{coll!r} (no wire invariant on record)", node=p.name)
            ok = False
        expect = sorted(a for a, k in part[ref] for _ in range(k)
                        if a != axis)
        if sorted(other) != expect:
            rep.add(COMM_NOT_CONSERVED,
                    f"{label}: node {p.name!r} residual-shard divisor "
                    f"{sorted(other)} != reference tensor partition "
                    f"{expect} minus axis {axis!r}", node=p.name)
            ok = False
    s = sp.Symbol("s", positive=True)
    for coll, node in sorted(used.items()):
        if coll == "SendRecv":
            continue                      # point-to-point: wire == size
        for n in sizes or [2]:
            wire, steps = _compiled.collective_wire(coll, s, n)
            want = _reference_wire(coll, s, n)
            if want is not None and sp.simplify(wire - want) != 0:
                rep.add(COMM_NOT_CONSERVED,
                        f"{label}: {coll} wire polynomial {wire} != "
                        f"ring-term invariant {want} at group {n}",
                        node=node)
                ok = False
                break
            if steps != _reference_steps(coll, n):
                rep.add(COMM_NOT_CONSERVED,
                        f"{label}: {coll} step count {steps} != ring "
                        f"algorithm's {_reference_steps(coll, n)} at "
                        f"group {n}", node=node)
                ok = False
                break
    rep.tally("prove.collectives", len(used))
    return ok


# --------------------------------------------------------------------------
# STG605 — bound soundness
# --------------------------------------------------------------------------

def _prod_deg(mesh: dict, pattern) -> float:
    d = 1
    for a, k in pattern:
        d *= mesh[a] ** k
    return d


def _floor_reference(prog: CostProgram, cfg: ParallelCfg,
                     hw: HardwareProfile, recompute: bool,
                     comm_ok: bool) -> tuple:
    """Independent re-derivation of the branch-and-bound floor pieces
    ``(M, path, O)`` from the frozen layout templates and exact lowered
    tables — same bucket semantics as :func:`repro_torch.core.dse._cell_floor`
    but sharing none of its code path."""
    info = prog.introspect()
    mesh = cfg.mesh
    numel, db = info["numel"], info["dbytes"]
    part, gb = info["part"], info["gbytes"]
    ln = [float(numel[i]) / _prod_deg(mesh, part[i])
          for i in range(len(numel))]
    lb = [ln[i] * db[i] for i in range(len(numel))]
    eins = {i: tuple((float(v), axes) for v, axes in letters)
            for i, letters in info["eins"].items()}
    entries = prog.layout_entries(max(1, cfg.pp), getattr(cfg, "vstages", 1))
    peak, hbm, eff = hw.peak_flops, hw.hbm_bw, hw.efficiency
    lat = hw.link_latency
    comp_s: dict = {}
    comm_s: dict = {}
    oc_s: dict = {}
    om_s: dict = {}
    fpc: dict = {}
    fpm: dict = {}
    bpc: dict = {}
    bpm: dict = {}

    def bump(d, k, v):
        d[k] = d.get(k, 0.0) + v

    for e in entries:
        cm, ph, stage, chunk = e[11], e[4], e[5], e[6]
        if cm is not None:
            if not comm_ok:
                continue
            if cm[0] == "SendRecv":
                bw = hw.link_bw_axis.get("pp", hw.link_bw)
                d = lb[cm[1]] / bw + lat
            else:
                coll, axis, ref, other = cm
                n = mesh[axis]
                if n <= 1:
                    continue
                full = gb[ref]
                for a in other:
                    full /= mesh[a]
                size = (full if coll in _compiled._PER_RANK_COLLS
                        else full / n)
                wire, steps = _compiled.collective_wire(coll, size, n)
                bw = hw.link_bw_axis.get(axis, hw.link_bw)
                d = wire / bw + steps * lat
            if ph == "opt":
                bump(om_s, stage, d)
            else:
                bump(comm_s, stage, d)
                bump(fpm if ph == "fwd" else bpm, chunk, d)
            continue
        flop = e[8]
        if flop is None:
            flops = 0.0
        elif flop[0] == "scale":
            flops = flop[1] * ln[flop[2]]
        else:
            flops = 2.0
            for fval, axes in eins[flop[1]]:
                deg = 1
                for a in axes:
                    deg *= mesh[a]
                flops *= fval / deg
        ba = 0.0
        for t in e[9]:
            ba += lb[t]
        d = max(flops / (peak * eff.get(e[3], 0.9)) if flops else 0.0,
                ba / hbm)
        if ph == "opt":
            bump(oc_s, stage, d)
        elif ph == "fwd":
            bump(comp_s, stage, d)
            bump(fpc, chunk, d)
            if recompute:
                bump(comp_s, stage, d)
                bump(bpc, chunk, d)
        else:
            bump(comp_s, stage, d)
            bump(bpc, chunk, d)
    stages = set(comp_s) | set(comm_s)
    big_m = max((max(comp_s.get(x, 0.0), comm_s.get(x, 0.0))
                 for x in stages), default=0.0)
    ostages = set(oc_s) | set(om_s)
    big_o = max((max(oc_s.get(x, 0.0), om_s.get(x, 0.0))
                 for x in ostages), default=0.0)
    chunks = set(fpc) | set(fpm) | set(bpc) | set(bpm)
    path = sum(max(fpc.get(c, 0.0), fpm.get(c, 0.0))
               + max(bpc.get(c, 0.0), bpm.get(c, 0.0)) for c in chunks)
    return big_m, path, big_o


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= _REL * max(1.0, abs(a), abs(b))


def _check_bound_semantics(rep: Report) -> bool:
    """Behavioral contract of :func:`repro_torch.core.dse.step_lower_bound`:
    the chunk-chain path term applies exactly to the schedules where a
    whole chunk slot is the dependency unit — never to pipelined zb-h1,
    always otherwise."""
    floor = (1.0, 100.0, 0.5)
    cases = (
        (ParallelCfg(pp=2, microbatches=2, schedule="zb-h1"), 2.5),
        (ParallelCfg(pp=2, microbatches=2, schedule="1f1b"), 100.5),
        (ParallelCfg(pp=2, microbatches=2, schedule="gpipe"), 100.5),
        (ParallelCfg(pp=1, microbatches=2, schedule="zb-h1"), 100.5),
    )
    ok = True
    for cfg, want in cases:
        got = _dse.step_lower_bound(cfg, floor)
        if abs(got - want) > 1e-12:
            rep.add(BOUND_UNSOUND,
                    f"step_lower_bound({cfg.schedule}, pp={cfg.pp}, "
                    f"mb={cfg.microbatches}) = {got} != sound {want} "
                    f"under floor {floor}")
            ok = False
    rep.tally("prove.bound_semantics", len(cases))
    return ok


# --------------------------------------------------------------------------
# STG606 — memory monotonicity
# --------------------------------------------------------------------------

def _check_memory(rep: Report, prog: CostProgram, info: dict,
                  probes: list, recompute: bool, label: str) -> bool:
    """Static proof: every peak-memory term is ``bytes / deg-monomial``
    with non-negative exponents and non-negative volumes over a
    degree-independent event structure, hence non-increasing in each
    axis degree.  Confirmed numerically on comparable lattice pairs."""
    ok = True
    names = info["names"]
    for i, pat in enumerate(info["part"]):
        for a, k in pat:
            if k < 0:
                rep.add(MEM_NOT_MONOTONE,
                        f"{label}: tensor {names[i]!r} has negative "
                        f"partition exponent {k} on axis {a!r} — bytes "
                        f"grow with the degree", node=names[i])
                ok = False
        if info["numel"][i] < 0:
            rep.add(MEM_NOT_MONOTONE,
                    f"{label}: tensor {names[i]!r} has negative element "
                    f"count {info['numel'][i]}", node=names[i])
            ok = False
    if ok:
        mems = [(tuple(c.axes.get(a, 1) for a in sorted(c.axes)),
                 prog.peak_memory(c, recompute=recompute).peak_gb)
                for c in probes]
        for d1, m1 in mems:
            for d2, m2 in mems:
                if d1 != d2 and all(x <= y for x, y in zip(d1, d2)) \
                        and m2 > m1 * (1.0 + _REL) + _REL:
                    rep.add(MEM_NOT_MONOTONE,
                            f"{label}: peak memory rises from "
                            f"{m1:.3f} GB at degrees {d1} to "
                            f"{m2:.3f} GB at {d2}")
                    ok = False
    rep.tally("prove.mem_tensors", len(info["part"]))
    return ok


def _check_inflight(rep: Report, cfgs: list) -> bool:
    """Peak memory is ``fixed(degrees) + peak_act(degrees) * inflight``
    with ``inflight`` a pure function of (schedule, pp, mb, vstages);
    if it is non-decreasing in mb for every pipelined combo the space
    sweeps, a smaller-mb exact memory bounds every larger-mb candidate
    of the same cell from below.  (At pp <= 1 the factor is constant 1,
    so the property is trivial there.)"""
    from ..core.schedules import inflight_factor
    combos: dict = {}
    for cfg in cfgs:
        if max(1, cfg.pp) <= 1:
            continue
        combos.setdefault(
            (cfg.schedule, cfg.pp, getattr(cfg, "vstages", 1)),
            set()).add(cfg.microbatches)
    ok = True
    for (sched, pp, vs), mbs in sorted(combos.items()):
        prev = None
        for mb in sorted(mbs):
            try:
                f = inflight_factor(sched, pp, mb, vs, 0)
            except Exception:
                continue                # infeasible combo never evaluates
            if prev is not None and f < prev - 1e-12:
                ok = False
                rep.add(MEM_NOT_MONOTONE,
                        f"inflight factor of {sched} (pp={pp}) drops "
                        f"from {prev} to {f} as microbatches grow to "
                        f"{mb} — memory not monotone in mb")
            prev = f
    rep.tally("prove.inflight_combos", len(combos))
    return ok


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

def _normalize(cfg: ParallelCfg, *, pp: int = 1, vstages: int = 1
               ) -> ParallelCfg:
    """Collapse the guard-invisible dimensions of a config: guards (and
    the lowered program) depend only on axis degrees + strategy flags,
    so one probe per degree tuple covers every mb/schedule/placement."""
    return replace(cfg, pp=pp, microbatches=1,
                   schedule="interleaved" if vstages > 1 else "1f1b",
                   vstages=vstages, placement=())


def prove_space(engine: CompiledBackend, *, cfgs: Optional[list] = None,
                world: Optional[int] = None,
                hw: Optional[HardwareProfile] = None,
                recompute: bool = False, name: str = "",
                retrace: bool = True, **enum_kw) -> SpaceCertificate:
    """Prove the ``STG6xx`` invariants for every structure class a
    config space touches; see the module docstring for the rule family.

    The space is either an explicit ``cfgs`` list (what
    ``dse.sweep(prove=True)`` passes) or enumerated from ``world`` with
    the same ``**enum_kw`` that :func:`repro_torch.core.dse.enumerate_configs`
    takes.  The full space is enumerated — the class-irrelevant
    dimensions (microbatches, schedules, placements) collapse onto the
    degree lattice here, but the in-flight monotonicity pass must see
    every (schedule, mb, vstages) combo the space actually sweeps.
    ``retrace=False`` skips the guard-faithfulness re-trace (STG604),
    the only pass that re-runs the distributor."""
    if cfgs is None:
        if world is None:
            raise ValueError("prove_space needs cfgs or world")
        cfgs = list(_dse.enumerate_configs(world, **enum_kw))
    hw = hw or TPU_V5E
    comm_ok = getattr(hw, "topology", None) is None
    rep = Report(name=name or "prove")

    # ---- collapse the space onto its degree lattice ----------------------
    by_key: dict = {}          # structure key -> {degree tuple: probe cfg}
    cells_by_key: dict = {}    # structure key -> {(degrees, pp, vstages)}
    for cfg in cfgs:
        key = CompiledBackend._structure_key(cfg)
        axes = key[0]
        degs = tuple(cfg.axes[a] for a in axes)
        by_key.setdefault(key, {}).setdefault(degs, _normalize(cfg))
        cells_by_key.setdefault(key, set()).add(
            (degs, max(1, cfg.pp), getattr(cfg, "vstages", 1)))

    # ---- single-device reference for FLOP conservation -------------------
    prog0 = engine.program(ParallelCfg())
    totals0, bad0 = _flop_totals(prog0.introspect())
    for nm in bad0:
        rep.add(FLOP_NOT_CONSERVED,
                f"single-device copies of node {nm!r} disagree on shard "
                f"exponents", node=nm)

    bound_semantics_ok = _check_bound_semantics(rep)
    inflight_ok = _check_inflight(rep, cfgs)

    certs: list[ClassCertificate] = []
    partition_ok = True
    lattice_points = 0
    for key, lattice in sorted(by_key.items(), key=lambda kv: repr(kv[0])):
        axes = key[0]
        label = "mesh(" + ",".join(f"{a}" for a in axes) + ")" \
            + ("+fsdp" if key[6] else "") + ("+zero1" if key[7] else "")
        lattice_points += len(lattice)

        # probe every lattice point once (compiles missing classes)
        prog_of: dict = {}
        first_cfg: dict = {}
        for degs in sorted(lattice):
            probe = lattice[degs]
            try:
                prog = engine.program(probe)
            except InfeasibleConfigError as e:
                rep.add(INFEASIBLE_CONFIG,
                        f"{label}: degrees {dict(zip(axes, degs))} "
                        f"infeasible: {e}")
                continue
            prog_of[degs] = prog
            first_cfg.setdefault(id(prog), (prog, probe))

        # STG603 — exactly one guard set must claim each lattice point
        key_progs = engine.classes().get(key, [])
        for degs in sorted(prog_of):
            dmap = dict(zip(axes, degs))
            n = sum(1 for p in key_progs
                    if guards_match_degrees(p.guards, dmap))
            if n != 1:
                partition_ok = False
                rep.add(CLASS_OVERLAP,
                        f"{label}: degrees {dmap} match {n} structure "
                        f"class(es) — guards do not partition the space")
        # NOTE a cached class that matches ZERO points of this lattice
        # is *not* flagged: dispatch never selects it for this space
        # (the honest recompile covers its region), and a warm shared
        # engine legitimately holds classes probed for other spaces.
        rep.tally("prove.lattice_points", len(prog_of))

        # per-class proofs
        for prog, probe in first_cfg.values():
            info = prog.introspect()
            covered = tuple(d for d, p in prog_of.items() if p is prog)
            guards_ok = True
            if retrace:
                graph = engine.build()
                with record_guards() as fresh:
                    distribute(graph, probe, engine.env)
                if dict(fresh) != prog.guards:
                    guards_ok = False
                    rep.add(GUARD_UNFAITHFUL,
                            f"{label}: recorded guard set "
                            f"({len(prog.guards)} predicate(s)) differs "
                            f"from a fresh trace "
                            f"({len(fresh)} predicate(s)) at degrees "
                            f"{dict(zip(axes, covered[0]))}")
            flop_ok = _check_flops(rep, info, totals0, label)
            comm_ok_cls = _check_comm(rep, info, _group_sizes(covered),
                                      label)

            # STG605 — floor identity at every cell of this class
            bound_ok = bound_semantics_ok
            for degs, pp, vstages in sorted(cells_by_key[key]):
                if prog_of.get(degs) is not prog:
                    continue
                cell_cfg = _normalize(lattice[degs], pp=pp, vstages=vstages)
                got = _dse._cell_floor(prog, cell_cfg, hw, recompute,
                                       comm_ok)
                want = _floor_reference(prog, cell_cfg, hw, recompute,
                                        comm_ok)
                for piece, g, w in zip(("M", "path", "O"), got, want):
                    if not _close(g, w):
                        bound_ok = False
                        rep.add(BOUND_UNSOUND,
                                f"{label}: floor piece {piece} = {g} "
                                f"disagrees with the independent "
                                f"re-derivation {w} at degrees "
                                f"{dict(zip(axes, degs))}, pp={pp}")
                rep.tally("prove.cells")

            probes = [lattice[d] for d in covered]
            mem_ok = _check_memory(rep, prog, info, probes, recompute,
                                   label)
            certs.append(ClassCertificate(
                label=label, axes=axes, degrees=covered,
                flop_conserved=flop_ok, comm_conserved=comm_ok_cls,
                guards_faithful=guards_ok, bound_sound=bound_ok,
                mem_monotone=mem_ok, program=prog))
        rep.tally("prove.classes", len(first_cfg))

    return SpaceCertificate(name=name or "prove", report=rep,
                            classes=certs, partition_ok=partition_ok,
                            configs=len(cfgs),
                            lattice_points=lattice_points,
                            inflight_monotone=inflight_ok)
