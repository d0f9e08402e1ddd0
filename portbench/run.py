"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks for:
exits with 3 and prints no result where ``torch.cuda`` has no device or too
few.  Set-up (``setup_s``) runs from the start of this process to the first
timed step: imports, the weights drawn on the card from the seed, the
kernels built (only the first run in a checkout compiles them, into the
port's ``src/repro_torch/kernels/_build/``) and the cell's own shapes warmed
up.  Then the window, the traced stretch with ``--trace 1``, the output
check against the plain reference, and as the last lines: the check's
numbers with their limits on stderr, the result's JSON on stdout."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from portbench import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import core, manifest
    bench = manifest.Bench(ROOT)
    bad = manifest.problems(bench)
    if bad:
        print("BENCHMARK.json: " + "; ".join(bad), file=sys.stderr)
        return 2
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, lines = core.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), device, T_START, bench)
    for s in lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
