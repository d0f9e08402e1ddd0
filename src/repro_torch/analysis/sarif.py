"""SARIF 2.1.0 export for the static-analysis diagnostics.

Converts :class:`~repro_torch.analysis.diagnostics.Report` objects into one
Static Analysis Results Interchange Format log so STG findings surface
in GitHub code scanning (and any other SARIF consumer).  Rule metadata
— code, default severity, help text — comes straight from the registry
(:data:`~repro_torch.analysis.diagnostics.RULES`), so the exported rules
never drift from what the passes can actually emit.

The diagnostics describe *artifacts* (graphs, workloads, traces), not
source files, so results carry logical locations (the diagnostic locus:
node / rank / stage / phase) rather than physical ones.
"""
from __future__ import annotations

import json
from typing import Iterable

from .diagnostics import ERROR, INFO, RULES, WARN, Diagnostic, Report

_SARIF_VERSION = "2.1.0"
_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                 "master/Schemata/sarif-schema-2.1.0.json")
_LEVEL = {ERROR: "error", WARN: "warning", INFO: "note"}


def _rule_descriptor(code: str) -> dict:
    r = RULES[code]
    return {
        "id": r.code,
        "name": r.code,
        "shortDescription": {"text": r.title},
        "defaultConfiguration": {"level": _LEVEL[r.severity]},
        "helpUri": "https://github.com/mlcommons/chakra",  # trace schema home
        "help": {"text": f"{r.code} ({r.severity}): {r.title}"},
    }


def _result(d: Diagnostic, report_name: str) -> dict:
    out: dict = {
        "ruleId": d.code,
        "level": _LEVEL.get(d.severity, "warning"),
        "message": {"text": d.message},
    }
    locus = d.locus()
    logical = " ".join(b for b in (report_name, locus) if b)
    if logical:
        out["locations"] = [{
            "logicalLocations": [{"fullyQualifiedName": logical}],
        }]
    if d.fixit:
        out["fixes"] = [{"description": {"text": d.fixit}}]
    return out


def to_sarif(reports: Iterable[Report], *,
             tool_name: str = "repro_torch.analysis") -> dict:
    """One SARIF run covering every report: all registered rules in the
    driver metadata, one result per diagnostic."""
    reports = list(reports)
    results = [_result(d, rep.name)
               for rep in reports for d in rep.diagnostics]
    return {
        "$schema": _SARIF_SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": tool_name,
                "informationUri":
                    "https://arxiv.org/abs/2511.10480",   # STAGE paper
                "rules": [_rule_descriptor(c) for c in sorted(RULES)],
            }},
            "results": results,
        }],
    }


def write_sarif(reports: Iterable[Report], path: str, *,
                tool_name: str = "repro_torch.analysis") -> None:
    """Serialize :func:`to_sarif` to ``path`` (UTF-8 JSON)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_sarif(reports, tool_name=tool_name), f, indent=2)
        f.write("\n")
