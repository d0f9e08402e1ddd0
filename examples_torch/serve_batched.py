"""Batched serving example: continuous batching over serve_step.

    PYTHONPATH=src python examples_torch/serve_batched.py      # the card
    PYTHONPATH=src python examples_torch/serve_batched.py --device cpu \
        --attention-impl naive

On the card every attention runs through the hand-written flash kernel
(``--attention-impl cuda``, the default); ``naive`` is the plain PyTorch
core.  ``main(params=...)`` serves a given parameter tree instead of the
seeded one (``repro_torch.models.convert`` carries one across).
"""
import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import ModelSpec
from repro_torch.launch.preflight import announce, preflight
from repro_torch.models import RuntimeCfg, init_params
from repro_torch.serve import Engine, Request

spec = ModelSpec(name="serve-demo", n_layers=4, d_model=128, n_heads=4,
                 n_kv_heads=2, d_ff=512, vocab=4096)


def main(argv=None, params=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    ap.add_argument("--attention-impl", default="cuda",
                    choices=("cuda", "chunked", "naive"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rt = RuntimeCfg(attention_impl=args.attention_impl)
    try:
        announce("serve", preflight(spec, mode="decode", batch=4, seq=1,
                                    kv_len=128))
    except Exception as e:  # noqa: BLE001 — advisory only, never blocks
        print(f"[serve] STAGE pre-flight unavailable: {e}")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(spec, rt, gen, device=device)

    engine = Engine(spec, rt, params, batch_slots=4, kv_len=128,
                    device=device)
    rng = np.random.RandomState(0)
    for rid in range(8):
        engine.submit(Request(rid=rid,
                              prompt=rng.randint(1, spec.vocab,
                                                 size=rng.randint(3, 9)),
                              max_new=12))
    done = engine.run(max_steps=200)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"request {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    print(f"{len(done)} requests served with 4 slots (continuous batching)")
    return done


if __name__ == "__main__":
    main()
