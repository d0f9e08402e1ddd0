"""Serving launcher (batched continuous decoding) on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --smoke --device cpu

The symbolic pre-flight line of `repro.launch.serve` comes with the port of the
generator.
"""
import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get as get_arch
from repro_torch.models import init_params
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--kv-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card the default "
                         "raises rather than running on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    spec = arch.smoke if args.smoke else arch.spec
    rt = arch.runtime                  # attention through the CUDA kernel
    params = init_params(spec, rt, device=device, seed=0)
    engine = Engine(spec, rt, params, batch_slots=args.slots,
                    kv_len=args.kv_len, device=device)
    rng = np.random.RandomState(0)
    for rid in range(args.requests):
        engine.submit(Request(rid=rid,
                              prompt=rng.randint(1, spec.vocab,
                                                 size=rng.randint(3, 9)),
                              max_new=args.max_new))
    done = engine.run(max_steps=400)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: -> {r.out}")
    print(f"served {len(done)}/{args.requests}")
    return done


if __name__ == "__main__":
    main()
