"""Static analysis for STAGE artifacts (graphs, workloads, schedules,
Chakra exports).

Four pass families, each a pure traversal (no sympy evaluation, no
simulation), reported through one diagnostics framework:

* :func:`lint_graph` / :func:`check_guards` — symbolic-graph lint
  (``STG0xx``): dangling tensors, dead ops, cycles, unbound symbols,
  einsum dim consistency, divisibility-guard contradictions.
* :func:`check_comm` — distributed comm checks (``STG1xx``): Send/Recv
  pairing, collective-group consistency, volume-conservation
  invariants.
* :func:`check_schedule` / :func:`check_workload_schedule` — slot-
  timeline checks (``STG2xx``): coverage, bwd_in/bwd_w ordering,
  deadlock-freedom.
* :func:`check_trace` / :func:`check_trace_dir` — Chakra trace
  validation (``STG3xx``): id uniqueness, dep resolution, DAG
  acyclicity, microbatch expansion, kv-transfer matching, SPMD rank
  agreement, manifest audit.
* :mod:`resilience_checks` — resilience-annotation checks (``STG4xx``),
  run as part of the trace passes: failure/restore epoch alternation
  and monotonicity, pair completeness, manifest agreement, checkpoint-
  step regression.
* :func:`check_timeline` / :func:`check_timeline_file` — observability
  timeline audit (``STG5xx``): Chrome-trace schema, scheduling-stream
  tiling against the recorded step time, comm-span annotations,
  resilience-track epoch order.
* :func:`prove_space` — the symbolic invariant prover (``STG6xx``):
  certifies FLOP/comm conservation, guard completeness/disjointness,
  branch-and-bound soundness, and memory monotonicity per *structure
  class* — i.e. for entire DSE spaces at once, not single traces.

High-level entry points: :meth:`repro_torch.api.Trace.verify`,
:meth:`repro_torch.api.Job.verify`, :meth:`repro_torch.api.Scenario.prove`,
``python -m repro_torch.analysis <trace_dir>``,
``python -m repro_torch.analysis --timeline <file.json>``,
``python -m repro_torch.analysis --prove``; every mode exports SARIF via
``--sarif out.json`` (:func:`to_sarif`).

Own copy of ``repro.analysis`` (sympy + numpy).  The port names itself
where the reference's strings name ``repro``: the CLI's ``prog``, SARIF's
default ``tool_name`` and the unbound-symbol fixit.
"""
from .comm_checks import check_comm
from .diagnostics import (Diagnostic, RULES, Report, SEVERITIES, rule)
from .graph_lint import check_guards, lint_graph
from .prover import ClassCertificate, SpaceCertificate, prove_space
from .resilience_checks import (check_resilience_manifest,
                                check_resilience_nodes, resilience_markers)
from .sarif import to_sarif, write_sarif
from .schedule_checks import check_schedule, check_workload_schedule
from .timeline_checks import check_timeline, check_timeline_file
from .trace_checks import check_trace, check_trace_dir

__all__ = [
    "Diagnostic", "Report", "RULES", "SEVERITIES", "rule",
    "lint_graph", "check_guards", "check_comm",
    "check_schedule", "check_workload_schedule",
    "check_trace", "check_trace_dir",
    "check_resilience_nodes", "check_resilience_manifest",
    "resilience_markers",
    "check_timeline", "check_timeline_file",
    "verify_workload", "verify_graph",
    "prove_space", "SpaceCertificate", "ClassCertificate",
    "to_sarif", "write_sarif",
]


def verify_workload(w, *, graph=None, env=None, name: str = "") -> Report:
    """All in-memory pass families for one instantiated workload: comm
    checks, schedule checks, and — when its symbolic ``graph`` is
    available — graph lint."""
    rep = Report(name=name or w.name)
    if graph is not None:
        rep.extend(lint_graph(graph, env))
    rep.extend(check_comm(w))
    rep.extend(check_workload_schedule(w))
    return rep


def verify_graph(graph, env=None, *, guards=None, cfg=None,
                 name: str = "graph") -> Report:
    """Graph lint plus (optionally) guard-contradiction checks."""
    rep = lint_graph(graph, env, name=name)
    if guards is not None and cfg is not None:
        rep.extend(check_guards(guards, cfg))
    return rep
