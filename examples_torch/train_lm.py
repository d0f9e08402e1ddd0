"""End-to-end training driver: data pipeline -> train_step -> checkpoints.

Defaults train a ~20M-param LM for 50 steps (a few minutes on the CPU);
``--d-model 768 --layers 12 --steps 300`` is the ~100M-scale run for the
card.  Demonstrates: deterministic resume after a simulated crash, keep-N
checkpoint rotation, and the straggler watchdog.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 50      # the card
    PYTHONPATH=src python examples_torch/train_lm.py --steps 50 --device cpu

Training runs the plain PyTorch paths (chunked attention), so it launches
none of the hand-written kernels, which are forward only.  ``main`` returns
every step's loss; ``main(params=...)`` starts from a given parameter tree
instead of the seeded one.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import ModelSpec
from repro_torch.data import DataCfg, TokenPipeline
from repro_torch.ft import StragglerWatchdog
from repro_torch.launch.preflight import announce, preflight
from repro_torch.models import RuntimeCfg, init_params
from repro_torch.train import OptCfg, init_opt_state, make_train_step


def main(argv=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a failure at this step (then rerun to resume)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = ModelSpec(name="train-demo", n_layers=args.layers,
                     d_model=args.d_model, n_heads=args.d_model // 64,
                     n_kv_heads=max(1, args.d_model // 128),
                     d_ff=4 * args.d_model, vocab=args.vocab)
    rt = RuntimeCfg(attention_impl="chunked", attn_chunk=128)
    n_params = spec.params()
    print(f"model: {n_params/1e6:.1f}M params")
    # symbolic pre-flight: what does the analytic model expect this
    # training step to cost?  (pure sympy, runs before any step)
    try:
        announce("train_lm", preflight(spec, mode="train", batch=args.batch,
                                       seq=args.seq))
    except Exception as e:  # noqa: BLE001 — advisory only, never blocks
        print(f"[train_lm] STAGE pre-flight unavailable: {e}")

    pipe = TokenPipeline(DataCfg(global_batch=args.batch, seq_len=args.seq,
                                 vocab=args.vocab, seed=0))
    mgr = CheckpointManager(args.ckpt_dir, keep=2, every=20)
    watchdog = StragglerWatchdog(n_hosts=1)

    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(spec, rt, gen, device=device)
    opt = init_opt_state(params)
    state, start = mgr.resume({"params": params, "opt": opt}, device=device)
    if state is not None:
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")
    step_fn = make_train_step(spec, rt, OptCfg(lr=3e-3, warmup=10,
                                               total_steps=args.steps))

    losses = {}
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses[step] = float(metrics["loss"])
        dt = time.time() - t0
        d = watchdog.observe(dt)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[step]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.2f}s  [{d.kind}]")
        mgr.maybe_save(step + 1, {"params": params, "opt": opt})
        if args.crash_at and step + 1 == args.crash_at:
            print(f"simulated crash at step {step + 1}; rerun to resume")
            return losses
    print("done.")
    return losses


if __name__ == "__main__":
    main()
