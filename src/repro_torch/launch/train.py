"""Training launcher on the GPU, own copy of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-34b \\
        --smoke --device cpu --ckpt-dir /tmp/ck

``--smoke`` trains the reduced config; without it the published one.  It
runs on the card unless ``--device cpu``; without a card and without that
request it raises.  Wires together, as the JAX package's launcher does: the
config registry, the symbolic pre-flight line, the data pipeline, the train
step, the checkpoint manager with resume (a rerun in the same ``--ckpt-dir``
carries on from the last checkpoint) and the straggler watchdog.

Training runs the reference's own training paths in plain PyTorch
(``attention_impl="chunked"``, RWKV6's chunk loop), so it launches none of
the hand-written kernels, which are forward only.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get as get_arch
from repro_torch.data import DataCfg, TokenPipeline
from repro_torch.ft import StragglerWatchdog
from repro_torch.launch.preflight import announce, preflight
from repro_torch.models import RuntimeCfg, init_params, param_axes
from repro_torch.train import OptCfg, init_opt_state, make_train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(spec, *, steps: int = 20, batch: int = 4, seq: int = 64,
          ckpt_dir=None, device=None) -> dict:
    """Train ``spec`` from seed 0 (or from the last checkpoint in
    ``ckpt_dir``, default ``<tmp>/ckpt_<name>``) up to step ``steps``,
    saving every 10 steps (keep 2), and print the JAX package's lines.
    Each step's time ends in a device sync.  Returns the final ``params``
    and ``opt`` with ``start`` (the step it resumed at, 0 if none),
    ``losses``, ``step_s`` and ``save_s`` (by step) and ``resume_s``."""
    device = resolve_device(device)
    rt = RuntimeCfg(attention_impl="chunked", attn_chunk=max(64, seq))
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"training {spec.name}: {spec.params()/1e6:.1f}M params, "
          f"{n_dev} devices")
    try:
        announce("train", preflight(spec, mode="train", batch=batch,
                                    seq=seq, dp=n_dev,
                                    ep=spec.moe is not None))
    except Exception as e:  # noqa: BLE001 — advisory only, never blocks
        print(f"[train] STAGE pre-flight unavailable: {e}")

    pipe = TokenPipeline(DataCfg(global_batch=batch, seq_len=seq,
                                 vocab=spec.vocab, seed=0))
    mgr = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), f"ckpt_{spec.name}"),
        keep=2, every=10)
    watchdog = StragglerWatchdog(n_hosts=1)

    params = init_params(spec, rt, device=device, seed=0)
    opt = init_opt_state(params)
    axes = {"params": param_axes(spec)}
    t0 = time.perf_counter()
    state, start = mgr.resume({"params": params, "opt": opt}, device=device)
    _sync(device)
    out = {"start": start, "resume_s": time.perf_counter() - t0,
           "losses": {}, "step_s": {}, "save_s": {}}
    if state:
        params, opt = state["params"], state["opt"]
        del state
        print(f"resumed at step {start}")
    step_fn = make_train_step(spec, rt, OptCfg(lr=1e-3, warmup=5))

    for step in range(start, steps):
        t0 = time.time()
        b = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch(step).items()}
        params, opt, m = step_fn(params, opt, b)
        loss = float(m["loss"])
        _sync(device)
        dt = time.time() - t0
        d = watchdog.observe(dt)
        print(f"step {step:4d} loss {loss:.4f} ({dt:.2f}s) [{d.kind}]",
              flush=True)
        out["losses"][step], out["step_s"][step] = loss, dt
        t0 = time.perf_counter()
        if mgr.maybe_save(step + 1, {"params": params, "opt": opt},
                          axes=axes):
            out["save_s"][step + 1] = time.perf_counter() - t0
    print("done")
    return {"params": params, "opt": opt, **out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card the default "
                         "raises rather than running on the CPU")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    spec = arch.smoke if args.smoke else arch.spec
    return train(spec, steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
