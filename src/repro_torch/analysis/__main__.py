"""CLI: verify offline Chakra trace dirs, timeline exports, bundled
arch configs, or prove whole design spaces.

    python -m repro_torch.analysis <trace_dir> [...]    # exported trace dirs
    python -m repro_torch.analysis --configs            # lint every bundled arch
    python -m repro_torch.analysis --timeline tl.json   # audit timeline JSON
    python -m repro_torch.analysis --prove              # STG6xx space prover
    python -m repro_torch.analysis --prove --world 32   # ... at another world
    python -m repro_torch.analysis ... --sarif out.json # SARIF 2.1.0 export

Exit status 1 when any error-severity diagnostic is found (warnings do
not fail the run; add ``--strict`` to make them fatal).  ``--sarif``
writes every report of the run as one SARIF log for GitHub code
scanning, whatever the mode.
"""
from __future__ import annotations

import argparse
import sys

from . import check_timeline_file, check_trace_dir, write_sarif


def _verify_dirs(dirs: list[str], strict: bool, sink: list) -> int:
    bad = 0
    for d in dirs:
        rep = check_trace_dir(d)
        sink.append(rep)
        print(rep.render())
        if not rep.ok or (strict and rep.warnings):
            bad += 1
    return 1 if bad else 0


def _verify_timelines(paths: list[str], strict: bool, sink: list) -> int:
    """Audit saved Perfetto/Chrome-trace exports (``Trace.timeline`` /
    ``Job.timeline`` / ``repro_torch.obs`` profiles) — the ``STG5xx`` pass."""
    bad = 0
    for p in paths:
        rep = check_timeline_file(p)
        sink.append(rep)
        print(rep.render())
        if not rep.ok or (strict and rep.warnings):
            bad += 1
    return 1 if bad else 0


def _verify_configs(strict: bool, sink: list) -> int:
    """Lint every bundled arch (smoke-scale spec): train and decode
    workloads under a pipelined config, through all four in-memory pass
    families — the CI ``lint`` job's analyzer half."""
    from ..api import Scenario
    from ..configs import ARCHS, get

    bad = 0
    for name in ARCHS:
        spec = get(name).smoke
        for mode_label, sc in (
                ("train", Scenario(spec).train(batch=4, seq=32)),
                ("decode", Scenario(spec).decode(batch=4, kv_len=64))):
            tr = sc.parallel(dp=2, pp=2, microbatches=2).trace()
            rep = tr.verify(include_graph=True)
            rep.name = f"{name}/{mode_label}"
            sink.append(rep)
            print(rep.render())
            if not rep.ok or (strict and rep.warnings):
                bad += 1
    return 1 if bad else 0


def _prove_configs(world: int, strict: bool, sink: list) -> int:
    """Certify every bundled arch's whole ``world``-device design space
    symbolically (``STG6xx``) — the CI ``prove`` job."""
    from ..api import Scenario
    from ..configs import ARCHS, get

    bad = 0
    for name in ARCHS:
        spec = get(name).smoke
        for mode_label, sc in (
                ("train", Scenario(spec).train(batch=32, seq=64)),
                ("serve", Scenario(spec).decode(batch=4, kv_len=64))):
            cert = sc.prove(world)
            cert.report.name = f"{name}/{mode_label}"
            sink.append(cert.report)
            print(f"prove {name}/{mode_label}: {cert.summary()}")
            if not cert.ok or (strict and cert.report.warnings):
                print(cert.report.render())
                bad += 1
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verifier for STAGE trace dirs, configs, and "
                    "design spaces")
    ap.add_argument("trace_dirs", nargs="*",
                    help="export_ranks/export_job output directories")
    ap.add_argument("--configs", action="store_true",
                    help="verify every bundled arch config instead of "
                         "trace dirs")
    ap.add_argument("--timeline", action="store_true",
                    help="treat the positional paths as saved timeline "
                         "JSON files (Trace.timeline / Job.timeline "
                         "exports) and run the STG5xx audit")
    ap.add_argument("--prove", action="store_true",
                    help="run the STG6xx symbolic invariant prover over "
                         "every bundled arch's whole design space")
    ap.add_argument("--world", type=int, default=16,
                    help="device count for --prove spaces (default 16)")
    ap.add_argument("--sarif", metavar="OUT.json",
                    help="also write all diagnostics of this run as a "
                         "SARIF 2.1.0 log")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as fatal")
    args = ap.parse_args(argv)
    reports: list = []
    if args.prove:
        rc = _prove_configs(args.world, args.strict, reports)
    elif args.configs:
        rc = _verify_configs(args.strict, reports)
    elif args.timeline:
        if not args.trace_dirs:
            ap.error("--timeline needs at least one timeline JSON path")
        rc = _verify_timelines(args.trace_dirs, args.strict, reports)
    else:
        if not args.trace_dirs:
            ap.error("give at least one trace dir (or --configs/--prove)")
        rc = _verify_dirs(args.trace_dirs, args.strict, reports)
    if args.sarif:
        write_sarif(reports, args.sarif)
        print(f"sarif: {len(reports)} report(s) -> {args.sarif}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
