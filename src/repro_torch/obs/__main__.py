"""CLI over saved observability artifacts.

    python -m repro_torch.obs summarize run.json        # render a snapshot
    python -m repro_torch.obs diff before.json after.json
    python -m repro_torch.obs validate timeline.json [...]

``summarize``/``diff`` operate on metric snapshots saved with::

    json.dump(repro_torch.obs.snapshot(), open("run.json", "w"))

``validate`` runs the ``STG5xx`` timeline audit
(:func:`repro_torch.analysis.check_timeline_file`) over saved Perfetto JSON
(``Trace.timeline(path=...)`` / ``Job.timeline(path=...)`` / span
profiles); exit status 1 on any error-severity diagnostic.
"""
from __future__ import annotations

import argparse
import json
import sys

from .metrics import diff, format_diff, format_snapshot


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _summarize(path: str) -> int:
    print(format_snapshot(_load(path)))
    return 0


def _diff(a: str, b: str) -> int:
    print(format_diff(diff(_load(a), _load(b))))
    return 0


def _validate(paths: list[str]) -> int:
    from ..analysis import check_timeline_file
    bad = 0
    for p in paths:
        rep = check_timeline_file(p)
        print(rep.render())
        if not rep.ok:
            bad += 1
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize, diff, and validate observability "
                    "artifacts (metric snapshots, Perfetto timelines)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize",
                           help="render one saved metrics snapshot")
    p_sum.add_argument("snapshot", help="snapshot JSON file")
    p_diff = sub.add_parser("diff",
                            help="per-metric delta between two snapshots")
    p_diff.add_argument("before", help="baseline snapshot JSON")
    p_diff.add_argument("after", help="comparison snapshot JSON")
    p_val = sub.add_parser("validate",
                           help="STG5xx audit of saved timeline JSON")
    p_val.add_argument("timelines", nargs="+",
                       help="Chrome-trace JSON files")
    args = ap.parse_args(argv)
    if args.cmd == "summarize":
        return _summarize(args.snapshot)
    if args.cmd == "diff":
        return _diff(args.before, args.after)
    return _validate(args.timelines)


if __name__ == "__main__":
    sys.exit(main())
