"""Readings for the output check's limits, on the card, in one process:
for each seed, the cell's set-up and a window of ``--seconds``, then the
program's numbers against the reference and, for the first
``--control`` seeds, the control's (the reference in float8 e4m3 put in
the program's place).  One JSON line a seed.  ``--served-dtype float32``
(with ``--mix slots=8`` where the float32 weights and cache would not fit)
runs the program in float32: a second witness, which should serve the
reference's argmax.  The benchmark's own runs
never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 --control 3
"""
import time

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from portbench import env  # noqa: E402

env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--served-dtype", help="run the program in another "
                    "dtype (a witness: float32 against the reference)")
    ap.add_argument("--mix", action="append", default=[], metavar="KEY=N",
                    help="replace a number of the cell's traffic (a witness "
                    "that needs fewer slots to fit)")
    args = ap.parse_args(argv)
    import torch
    from portbench import core, manifest
    device = torch.device("cuda", 0)
    bench = manifest.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    if args.served_dtype:
        cfg["served_dtype"] = args.served_dtype
    mix = bench.traffic(cell["traffic"])
    for kv in args.mix:
        key, val = kv.split("=")
        mix[key] = int(val)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = core.setup(args.workload, seed, device, cfg=cfg, mix=mix)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window = ctx.load.measure(args.seconds)
        ctx.load.release()
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        numbers = core.judge(ctx, control=i < args.control)
        t3 = time.perf_counter()
        keep = {k: v for k, v in window.items() if isinstance(v, (int, float))}
        print(json.dumps({"seed": seed, "numbers": numbers, "window": keep,
                          "setup_s": t1 - t0, "judge_s": t3 - t2}),
              flush=True)
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
