"""Serving launcher (batched continuous decoding) on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --smoke --device cpu

Every arch of ``configs`` is served as the JAX package's launcher serves
it, through the decode path alone: whisper-medium decodes against its
cross-attention caches, which nothing fills (zeros), and internvl2-26b
without a vision prefix.  Before it serves, it prints the symbolic
pre-flight line (:mod:`repro_torch.launch.preflight`): the decode step's
predicted time and peak memory on the modelled cluster, priced for the
card it runs on (``H100_HGX`` on a CUDA device, the advisor's default
otherwise).
"""
import argparse

import numpy as np
import torch

from repro_torch import H100_HGX
from repro_torch._device import resolve_device
from repro_torch.configs import get as get_arch
from repro_torch.launch.preflight import announce, preflight
from repro_torch.models import init_params
from repro_torch.serve import Engine, Request


def announce_preflight(spec, *, slots: int, kv_len: int, device) -> None:
    """Print the ``STAGE pre-flight:`` line for a decode engine of ``slots``
    requests against a ``kv_len`` cache, one data-parallel replica per card,
    priced on the H100 on a CUDA device (advisory only: a failure prints why
    and never blocks serving)."""
    cuda = device.type == "cuda"
    hw = {"hw": H100_HGX} if cuda else {}
    try:
        announce("serve", preflight(spec, mode="decode", batch=slots,
                                    seq=1, kv_len=kv_len,
                                    dp=torch.cuda.device_count() if cuda
                                    else 1, ep=spec.moe is not None, **hw))
    except Exception as e:  # noqa: BLE001 — advisory only, never blocks
        print(f"[serve] STAGE pre-flight unavailable: {e}")


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

    arch = get_arch(args.arch)
    device = resolve_device(args.device)
    spec = arch.smoke if args.smoke else arch.spec
    rt = arch.runtime                  # attention through the CUDA kernel
    announce_preflight(spec, slots=args.slots, kv_len=args.kv_len,
                       device=device)
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
