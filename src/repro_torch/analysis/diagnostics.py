"""Diagnostics framework for the static-analysis passes.

Every check emits structured :class:`Diagnostic` records — a stable
rule code (``STG0xx`` graph lint, ``STG1xx`` distributed comm,
``STG2xx`` schedule, ``STG3xx`` Chakra trace, ``STG4xx`` resilience
annotations, ``STG5xx`` observability timelines, ``STG6xx`` symbolic
space prover), a severity, a locus
(node / rank / stage / phase), a human message, and an optional fixit
hint — collected into a :class:`Report`.  The registry below is the
single source of truth for code -> (severity, title); passes emit via
``Report.add(code, message, ...)`` so severities stay consistent and a
typo'd code fails loudly instead of silently producing an unknown
diagnostic.

The analyzers are *static*: pure Python traversal over already-built
artifacts (symbolic graphs, instantiated workloads, schedule timelines,
exported Chakra JSON).  Nothing here evaluates sympy expressions or
runs the simulator, so a full verify pass costs a small fraction of the
export it validates (guarded in ``benchmarks/perf_smoke.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

ERROR, WARN, INFO = "error", "warn", "info"
SEVERITIES = (ERROR, WARN, INFO)


class Rule(NamedTuple):
    code: str
    severity: str
    title: str


RULES: dict[str, Rule] = {}


def rule(code: str, severity: str, title: str) -> str:
    """Register a diagnostic rule; returns the code for use as a
    module-level constant."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity {severity!r} not in {SEVERITIES}")
    if code in RULES:
        raise ValueError(f"duplicate rule code {code}")
    RULES[code] = Rule(code, severity, title)
    return code


# ---- graph lint (STG0xx) --------------------------------------------------
DANGLING_TENSOR = rule("STG001", ERROR, "op consumes a tensor nothing produces")
UNREACHABLE_NODE = rule("STG002", WARN, "op output is never consumed")
GRAPH_CYCLE = rule("STG003", ERROR, "dependency cycle in the symbolic graph")
UNBOUND_SYMBOL = rule("STG004", ERROR, "shape symbol not bound by the env")
EINSUM_DIM_MISMATCH = rule("STG005", ERROR, "einsum letter binds to "
                                            "inconsistent dims")
GUARD_CONTRADICTION = rule("STG006", ERROR, "recorded divisibility guard "
                                            "contradicts the config")
INFEASIBLE_CONFIG = rule("STG007", INFO, "config infeasible for the swept "
                                         "workload")

# ---- distributed comm (STG1xx) --------------------------------------------
UNPAIRED_SENDRECV = rule("STG101", ERROR, "Send/Recv without a matching peer")
COLLECTIVE_MISMATCH = rule("STG102", ERROR, "collective group inconsistency "
                                            "across participants")
VOLUME_VIOLATION = rule("STG103", ERROR, "comm volume breaks the collective's "
                                         "conservation invariant")
BAD_COMM_METADATA = rule("STG104", ERROR, "malformed communication metadata")

# ---- schedule (STG2xx) ----------------------------------------------------
SCHEDULE_DEADLOCK = rule("STG201", ERROR, "schedule replay cannot make "
                                          "progress")
PHASE_NEVER_RAN = rule("STG202", ERROR, "slot consumes a microbatch phase "
                                        "that never ran")
BWD_SPLIT_ORDER = rule("STG203", ERROR, "bwd_w scheduled before its bwd_in")
SLOT_COVERAGE = rule("STG204", ERROR, "stage timeline misses or duplicates "
                                      "microbatch slots")

# ---- chakra trace (STG3xx) ------------------------------------------------
DUPLICATE_NODE_ID = rule("STG301", ERROR, "duplicate node id in a rank trace")
UNRESOLVED_DEP = rule("STG302", ERROR, "dependency edge references a missing "
                                       "node")
TRACE_CYCLE = rule("STG303", ERROR, "cycle in the data/control dependency "
                                    "graph")
MICROBATCH_INCONSISTENT = rule("STG304", ERROR, "per-microbatch expansion is "
                                                "inconsistent")
KV_TRANSFER_ORPHAN = rule("STG305", ERROR, "kv-transfer send/recv unmatched "
                                           "across pools")
ATTR_SCHEMA = rule("STG306", ERROR, "node attrs violate the Chakra schema")
RANK_DIVERGENCE = rule("STG307", ERROR, "SPMD ranks of one group disagree on "
                                        "their collective sequence")
STALE_TRACE_FILE = rule("STG308", ERROR, "trace dir contains files the "
                                         "manifest does not list")
EMPTY_TRACE_DIR = rule("STG309", ERROR, "trace dir holds no readable rank "
                                        "traces")

# ---- resilience annotations (STG4xx) --------------------------------------
RESILIENCE_EPOCH_ORDER = rule("STG401", ERROR, "resilience epochs out of "
                                               "order or non-monotone in time")
RESILIENCE_UNMATCHED = rule("STG402", ERROR, "failure marker without a "
                                             "matching restore (or vice versa)")
RESILIENCE_MANIFEST = rule("STG403", ERROR, "manifest resilience metadata "
                                            "disagrees with stamped events")
RESILIENCE_CKPT_REGRESSION = rule("STG404", ERROR, "restore rewinds to an "
                                                   "earlier checkpoint than a "
                                                   "prior epoch")

# ---- observability timelines (STG5xx) --------------------------------------
TIMELINE_SCHEMA = rule("STG501", ERROR, "timeline violates the Chrome-trace "
                                        "event schema")
TIMELINE_TILE = rule("STG502", ERROR, "stage scheduling stream has a gap or "
                                      "overlap between spans")
TIMELINE_STEP_MISMATCH = rule("STG503", ERROR, "stage track end disagrees "
                                               "with the recorded step time")
TIMELINE_COMM_ATTRS = rule("STG504", ERROR, "comm span missing its "
                                            "collective annotation")
TIMELINE_RESILIENCE_TRACK = rule("STG505", ERROR, "resilience track epochs "
                                                  "out of order or malformed")

# ---- symbolic space prover (STG6xx) ----------------------------------------
FLOP_NOT_CONSERVED = rule("STG601", ERROR, "distributed FLOPs are not the "
                                           "single-device FLOPs times an "
                                           "exact replication monomial")
COMM_NOT_CONSERVED = rule("STG602", ERROR, "collective wire-byte polynomial "
                                           "breaks the ring-term invariant")
CLASS_OVERLAP = rule("STG603", ERROR, "config matched by zero or multiple "
                                      "structure-class guard sets")
GUARD_UNFAITHFUL = rule("STG604", ERROR, "recorded guard set disagrees with "
                                         "a fresh distribution trace")
BOUND_UNSOUND = rule("STG605", ERROR, "branch-and-bound step floor exceeds "
                                      "the true step-time polynomial")
MEM_NOT_MONOTONE = rule("STG606", ERROR, "peak memory increases along a mesh "
                                         "degree within a structure class")


@dataclass(frozen=True)
class Diagnostic:
    """One finding: a registered code plus locus and message."""
    code: str
    severity: str
    message: str
    node: Optional[object] = None       # op/tensor uid, chakra node id, name
    rank: Optional[int] = None
    stage: Optional[int] = None
    phase: Optional[str] = None
    fixit: str = ""

    def locus(self) -> str:
        bits = []
        if self.rank is not None:
            bits.append(f"rank{self.rank}")
        if self.stage is not None:
            bits.append(f"stage{self.stage}")
        if self.phase is not None:
            bits.append(f"phase={self.phase}")
        if self.node is not None:
            bits.append(f"node={self.node}")
        return " ".join(bits)

    def render(self) -> str:
        loc = self.locus()
        out = f"{self.code} {self.severity}" + (f" [{loc}]" if loc else "")
        out += f": {self.message}"
        if self.fixit:
            out += f"  (fix: {self.fixit})"
        return out


@dataclass
class Report:
    """Collected diagnostics of one verify run.

    ``ok`` is True when no *error*-severity diagnostics were emitted;
    warnings and infos never fail a verify.  Reports merge with
    :meth:`extend`, so multi-artifact verifies (graph + workload +
    schedule + traces) accumulate into one."""
    name: str = ""
    diagnostics: list[Diagnostic] = field(default_factory=list)
    checked: dict[str, int] = field(default_factory=dict)   # pass -> items

    def add(self, code: str, message: str, *, node=None, rank=None,
            stage=None, phase=None, fixit: str = "",
            severity: Optional[str] = None) -> Diagnostic:
        r = RULES.get(code)
        if r is None:
            raise KeyError(f"unregistered diagnostic code {code!r}")
        d = Diagnostic(code=code, severity=severity or r.severity,
                       message=message, node=node, rank=rank, stage=stage,
                       phase=phase, fixit=fixit)
        self.diagnostics.append(d)
        return d

    def tally(self, pass_name: str, n: int = 1) -> None:
        self.checked[pass_name] = self.checked.get(pass_name, 0) + n

    def extend(self, other: "Report") -> "Report":
        self.diagnostics.extend(other.diagnostics)
        for k, v in other.checked.items():
            self.checked[k] = self.checked.get(k, 0) + v
        return self

    # ---- queries --------------------------------------------------------
    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARN]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def raise_if_errors(self) -> None:
        if not self.ok:
            raise AssertionError(self.render())

    # ---- rendering ------------------------------------------------------
    def render(self) -> str:
        head = f"verify {self.name}: " if self.name else "verify: "
        if not self.diagnostics:
            stats = ", ".join(f"{k}={v}" for k, v in sorted(self.checked.items()))
            return head + "OK" + (f" ({stats})" if stats else "")
        head += (f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)")
        lines = [head]
        lines += ["  " + d.render() for d in self.diagnostics]
        return "\n".join(lines)

    def __repr__(self) -> str:
        state = "ok" if self.ok else f"{len(self.errors)} errors"
        return f"Report({self.name or 'verify'}: {state}, " \
               f"{len(self.diagnostics)} diagnostics)"
