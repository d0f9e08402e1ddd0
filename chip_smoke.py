#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py              # everything, on one CUDA device
    python3 chip_smoke.py --phases build,kernels --ptxas-info
    python3 chip_smoke.py --phases build,kernels,sweep --profile
    python3 chip_smoke.py --phases build,kernels,serve --profile \
        --models jamba-v0.1-52b

Phases, one JSON line each on standard output:

  device   torch version, the card's name and power limit (nvidia-smi)
  build    compiles every CUDA source of ``repro_torch/kernels/csrc`` with nvcc,
           one compiler process per source, all started together
  kernels  each hand-written kernel (flash_attention, wkv6, cost_reduce)
           against its plain PyTorch version on the card, at the shapes of the
           main paths and at edge shapes: max abs error vs a stated tolerance,
           kernel / plain / library time and the card's bound for the same work.
           Attention shapes also print the kernel the wrapper chose (tc, fma
           or decode), the decode split, and the device time per launch
           beside the library's (the MLA rows, v's head dim 128 under q/k's
           192, also the library's backend, read with torch.profiler once
           the main paths have run); wkv6 shapes the kernel its wrapper chose
           (decode or tiled), the tile, and the device time per launch;
           cost_reduce rows (the sweep's merged calls first) the split its
           wrapper's rule chose, and its and torch.matmul's device times
  serve    ten served models, one after the other, each at published
           width, bf16, random weights from a seed: qwen3-14b (attention
           through flash_attention), rwkv6-7b (every WKV recurrence through
           wkv6: decode steps on its decode kernel, the prefill on its tiled
           kernel, counted apart), minitron-8b and deepseek-moe-16b at
           published depth, deepseek-v2-236b (MLA + MoE; 4 of 60 layers),
           gemma2-27b and granite-34b (8 layers each), jamba-v0.1-52b (Mamba
           + attention + MoE; 8 of 32 layers, one period; depth cuts listed
           as reduced), whisper-medium (24 encoder + 24 decoder layers) and
           internvl2-26b (48 layers).  For each, an Engine with 8 slots
           answers 16 requests, then one [2, 2048] prefill through
           lm.forward (gemma2 also one [1, 8192], so that its 4096-key
           window masks keys; whisper [2, 448], its decoder's context, with
           [2, 1500, 1024] frames; internvl2 after a [2, 256, 6144] vision
           prefix: logits [2, 2304, V]).  Every launch count is set to 0
           just before each model's run and read just after; each model's
           flash launches must be steps x (attention + cross-attention
           layers) + prefills x (encoder + attention + cross-attention
           layers).  Three warm prefills follow: every reading, their median
           as prefill_ms.  --models runs a subset (a partial run)
  sweep    the generator's design-space sweep on the batched backend:
           dse.sweep over every (dp, tp, cp, pp) factorisation of 64 devices
           for qwen3-14b's published spec, train, batch 256 x seq 4096, on
           H100_HGX, one cost_reduce launch per class call (checked); each
           point held against the compiled backend (rel 1e-6) and the whole
           sweep against the same sweep on the CPU (rel 1e-10).  Every launch
           count is set to 0 just before the sweep and read just after
  api      STAGE's front door on the card, at qwen3-14b's published widths:
           Scenario(spec).train(256 x 4096).with_backend("batched")
           .resilience(mtbf=3.6e6).sweep(64, H100_HGX, rank_by=
           "effective_goodput", device="cuda", max_pp=2, microbatches=(8,))
           through cost_reduce (one launch per class call, counted), held
           against the same scenario on the compiled backend on the host
           (rel 1e-6 by label, the same ranking) and on the CPU batched
           backend (rel 1e-10); a Job.request serving sweep over 8 devices
           (splits="auto") against the compiled backend; the best point's
           64 Chakra rank files (a second export byte-equal) and its
           timeline (schema-checked, reconciled); qwen3-14b's stage 0 over
           32 768 GPUs (dp 512, tp 8, pp 8); the serve launcher's
           pre-flight line.  Counts set to 0 just before and read just after
  parity   the smoke specs on the card in fp32, then in float16 (which the
           attention kernel reads as fp32): qwen3, granite, minitron,
           gemma2, deepseek-moe, deepseek-v2 (MLA: q/k 24, v 16 on the fma
           and fp32 decode kernels), jamba, whisper (with frames) and
           internvl2 (with a vision prefix) attention through the kernel
           against the naive core; rwkv6 through the wkv6 kernel against the
           same parameters on the CPU (the plain version).  Every engine
           step's logits and the prefill's within 1e-4 (fp32) / 5e-2
           (float16), the same greedy tokens (where a step's two best
           logits tie within that limit the engines may part there: the
           tie is reported)
  analysis STAGE's verifier and prover on the card's sweeps (run before the
           kernels line, after api): the sweep phase's qwen3-14b space with
           prove=True, verify=True on the card (the space certified, one
           STG007 diagnostic per skipped config, one cost_reduce launch per
           class call; counts set to 0 just before and read just after), its
           points against the same sweep without prove / verify on the card
           and on the CPU (rel 1e-10); bnb with and without the certificates
           (the same front and visits, candidates pruned by a certificate);
           Trace.verify of the best point, its 64 Chakra files through
           check_trace_dir and ``python -m repro_torch.analysis --sarif``,
           its timeline through check_timeline_file, Job.verify of the api
           phase's serving job, a dropped recv in a pipelined point's files
           reported as STG101; deepseek-v2-236b at published widths swept
           with verify=True on the card (a main path of its own, counted),
           against the CPU (rel 1e-10) and the compiled backend (rel 1e-6)

  train    training on the card, which runs no kernel: the attention and
           wkv6 kernels are forward only, as the Pallas kernels are, so
           training takes the reference's own training paths in plain
           PyTorch (attention_impl="chunked": online-softmax attention under
           checkpoint, RWKV6's chunk loop).  qwen3-14b and rwkv6-7b at
           published width, bf16, 4 layers each (reduced), remat "full",
           loss_chunk 512: six make_train_step steps on TokenPipeline batch
           0 [2, 2048], repeated, lr 1e-4 (the first a warm-up, five timed,
           ending in a sync): ms/step, tokens/s, peak GB, mfu (model FLOPs
           over the bf16 peak), every loss; the loss must fall by 0.3 and no
           kernel may launch.  Then train-parity: every family's smoke spec
           at fp32 (TF32 off), loss, gradients and one step's parameters on
           the card against the CPU; and the kernels' refusal:
           ops.flash_attention, ops.wkv6 and ops.cost_reduce raise on a CUDA
           input that requires grad, make_train_step with
           attention_impl="cuda" raises
  ckpt     the training launcher and checkpoints on the card, which run no
           kernel: deepseek-moe-16b at published widths cut to depth 2 of
           28 (the dense prefix layer and one MoE layer, 1.09 B
           parameters, a checkpoint of 10.9 GB: bf16 parameters, the fp32
           router, fp32 m and v) through launch.train.train on
           TokenPipeline [2, 2048].  Run A: 12 steps, saving at 10.  Run B,
           in a fresh directory: steps 0-10 (saving at 10), the saved state
           digested on the card leaf by leaf, restored (disk to device) and
           digested again (equal), then a second launcher call to 12 that
           prints "resumed at step 10"; its losses at steps 11-12 within
           1e-3 relative of run A's (the gap and whether they are
           bit-equal printed).  The manifest's axes equal param_axes(spec);
           every loss finite; no kernel launched; free space checked before
           each write (short: raise); each directory deleted once read.
           Bytes, save and restore seconds and GB/s, ms/step, peak GB
  shard    the ported sharding (parallel.sharding, launch.mesh, AxisRules
           and constrain, ZeRO-1, restore with shardings=) on a one-rank
           NCCL DeviceMesh (1, 1) ("data", "model") of the card, built by
           launch.mesh.make_mesh, with the rules the JAX package's dry run
           picks per arch (FSDP for an MoE model; sequence parallelism on).
           Training: deepseek-moe-16b at published widths, depth 2 of 28
           (the ckpt phase's model), the training launcher's runtime: six
           make_train_step steps on TokenPipeline batch 0 [2, 2048] with
           plain parameters, then the same six from the same seed with
           parameters placed by param_shardings, ZeRO-1 moments placed by
           opt_state_shardings and the rules: ms/step of each (the first a
           warm-up), peak GB, the largest relative gap of the losses (limit
           1e-6; bit-equal or not); the placed state saved and restored
           with shardings= (DTensors on the mesh, every leaf's bytes equal
           on the card).  Serving: qwen3-14b at published width and depth,
           attention through the kernel: the serve phase's 16 requests and
           [2, 2048] prefill, by the plain engine and by Engine(rules=)
           over the placed parameters; the same greedy tokens, and the
           same flash launches (counts set to 0 before each, 5520: the
           kernel ran on the local shards); decode ms/step and prefill ms
           of both.  The process group is destroyed at the phase's end.
           Multi-rank behaviour (expert parallelism, real collectives) is
           held on gloo ranks on the CPU (tests/test_torch_multirank.py):
           NCCL takes one rank per device
  dryrun   the multi-pod dry run (launch/dryrun.py), which runs no kernel:
           four cells, each ``python -m repro_torch.launch.dryrun`` in a
           subprocess of its own (each owns a fake process group of 256 or
           512 ranks), all started together: qwen3-14b train_4k on 16x16
           (FSDP), deepseek-moe-16b train_4k on 2x16x16 (the
           expert-parallel all-to-all), minitron-8b decode_32k (the cache
           sharded over its layers dimension), qwen3-14b prefill_32k
           (counted at two shallower depths and extrapolated); each record
           OK with finite counts, printed with its trace seconds.
           Meanwhile the card check: one training step of the train
           phase's qwen3-14b (published width, 4 layers, [2, 2048],
           TRAIN_RT) through the dry run's helper on a one-rank NCCL mesh,
           under fake tensors and then for real under the same counting
           mode: FLOPs and bytes equal, the predicted peak within
           CARD_PEAK_REL of torch.cuda.max_memory_allocated(), and the
           roofline time beside the measured ms/step

``--profile`` adds to each serve line a trace of four decode steps and of
one warm prefill: device-busy time, idle share, top kernels, and the device
time of Mamba's scan and conv, the MoE dispatch and combine (torch.profiler
ranges) and of the flash and cuBLAS kernels.

Each phase line carries the seconds since the script started.  After serve,
sweep, api and analysis, the ``kernels`` line: every kernel with its
launches on the main paths (flash_attention's summed over the served
models, each model's count under ``launches_by_path``; cost_reduce's of the
sweep phase; the api and analysis phases report their own counts).  Then the line nvidia-smi gives
for the card, and as the last line ``{"ok": true, "device": {...}}``.  Any failure is an exception and a non-zero
exit code; without a CUDA device the script exits non-zero before any phase.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False\n")
    sys.exit(1)

from repro_torch.configs import get as get_arch  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cost_reduce as cr  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv  # noqa: E402
from repro_torch.data import DataCfg, TokenPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.dryrun import arch_rules  # noqa: E402
from repro_torch.models import (RuntimeCfg, init_params, lm,  # noqa: E402
                                param_axes)
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.train import (OptCfg, init_opt_state,  # noqa: E402
                               make_train_step)
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

DEV = torch.device("cuda", 0)

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,     # tensor cores
              torch.float32: 67e12,       # fp32 units; exact fp32 products
              torch.float64: 67e12}       # fp64 tensor cores (DMMA)
# kernel vs plain version: |err| <= absolute + relative * |plain|.  fp32 sums
# differ only in their order.  bf16 outputs are rounded once on each side, so
# two bf16 ulps relative, and a hundredth of the output's rms so that the
# limit follows the output's size (at 2048 keys the rms is about 0.04)
TOL = {torch.float32: dict(absolute=2e-5, rms_share=0.0, relative=2e-5),
       torch.bfloat16: dict(absolute=0.0, rms_share=1e-2, relative=2.0 ** -7)}

PHASES = ("build", "kernels", "serve", "sweep", "api", "parity", "analysis",
          "train", "ckpt", "shard", "dryrun")
# the kernels' wrapper modules, each with its launch count, and their sources
COUNTERS = {"flash_attention": fa, "wkv6": wkv, "cost_reduce": cr}
SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "wkv6": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
           "cost_reduce": "src/repro_torch/kernels/csrc/cost_reduce.cu"}


def reset_counts() -> None:
    """Every kernel's launch count to 0 (and wkv6's count by variant)."""
    for module in COUNTERS.values():
        module.launches = 0
    for variant in wkv.launches_by_variant:
        wkv.launches_by_variant[variant] = 0


def require(ok, message) -> None:
    """A check that stays under ``python -O``."""
    if not ok:
        raise AssertionError(message)


START = time.perf_counter()


def emit(name: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": name, **fields,
                      "elapsed_s": time.perf_counter() - START}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, budget_ms: float = 400.0, max_iters: int = 50) -> float:
    """Mean device time of ``fn`` from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = max(3, min(max_iters, int(budget_ms / max(start.elapsed_time(end),
                                                      1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 40, spin_cycles: int = 20_000_000) -> tuple:
    """Device time per call of ``fn``: the calls are queued behind a spin of
    the card (``torch.cuda._sleep``) that outlasts the host's enqueueing, so
    the events bracket back-to-back device work, not the host's call rate.
    Returns (ms per call, whether the host had queued every call before the
    spin ended); the spin doubles until it has."""
    fn()
    torch.cuda.synchronize()
    e0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for _ in range(4):
        e0.record()
        torch.cuda._sleep(spin_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        ahead = host_ms < e0.elapsed_time(start)
        if ahead:
            break
        spin_cycles *= 2
    return start.elapsed_time(end) / calls, ahead


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
ATTENTION_CASES = [
    # the two shapes the qwen3-14b serve path gives the kernel
    dict(name="prefill", main=True, B=2, N=8, G=5, Sq=2048, Sk=2048, D=128,
         dtype=BF16, causal=True),
    dict(name="decode", main=True, B=8, N=8, G=5, Sq=1, Sk=2048, D=128,
         dtype=BF16, causal=True, q_offset=2047),
    # decode in the middle of a cache: keys past q_offset are skipped
    dict(name="decode-partial", B=8, N=8, G=5, Sq=1, Sk=2048, D=128,
         dtype=BF16, causal=True, q_offset=100),
    # edge shapes
    dict(name="ragged-causal", B=2, N=2, G=1, Sq=96, Sk=160, D=80, dtype=F32,
         causal=True),
    dict(name="ragged-full", B=2, N=1, G=2, Sq=96, Sk=160, D=80, dtype=F32,
         causal=False),
    dict(name="window-softcap", B=1, N=2, G=1, Sq=256, Sk=256, D=64,
         dtype=F32, causal=True, window=64, softcap=30.0),
    dict(name="window-only-bf16", B=1, N=2, G=2, Sq=300, Sk=300, D=32,
         dtype=BF16, causal=True, window=32),
    dict(name="smoke-prefill-d16", B=2, N=2, G=4, Sq=24, Sk=24, D=16,
         dtype=F32, causal=True),
    dict(name="smoke-decode-d16", B=2, N=2, G=4, Sq=1, Sk=64, D=16, dtype=F32,
         causal=True, q_offset=10),
    # the decode kernel's other head-dim variants, window and softcap
    dict(name="decode-d32-bf16", B=3, N=2, G=2, Sq=1, Sk=333, D=32, dtype=BF16,
         causal=True, q_offset=332),
    dict(name="decode-d64-window", B=2, N=3, G=1, Sq=1, Sk=500, D=64,
         dtype=F32, causal=True, q_offset=400, window=128),
    dict(name="decode-d80-softcap", B=2, N=2, G=3, Sq=1, Sk=200, D=80,
         dtype=F32, causal=True, q_offset=150, window=50, softcap=20.0),
    # the full-width decode instance held at the fp32 limit over a long cache
    dict(name="decode-d128-fp32", B=2, N=2, G=5, Sq=1, Sk=2048, D=128,
         dtype=F32, causal=True, q_offset=2040),
    dict(name="decode-full-not-causal", B=2, N=2, G=2, Sq=1, Sk=77, D=128,
         dtype=BF16, causal=False),
    # a few new tokens at once against a cache: the tile kernel with an offset
    dict(name="multi-token-decode", B=2, N=2, G=5, Sq=4, Sk=512, D=128,
         dtype=BF16, causal=True, q_offset=300),
    # rows that see no key (window, no causal mask, a large offset): the mean
    # of v over all Sk keys, as ref_attention.  Tile kernel: rows 0-58 see
    # keys, rows 59-79 none; decode kernel: the one row sees none
    dict(name="no-visible-key", B=2, N=2, G=2, Sq=80, Sk=128, D=64, dtype=F32,
         causal=False, window=32, q_offset=100),
    dict(name="decode-no-visible-key", B=2, N=2, G=2, Sq=1, Sk=128, D=64,
         dtype=BF16, causal=False, window=16, q_offset=300),
    # the tensor-core kernel's edges (bf16, Sq > 1): ragged Sq, Sk and D,
    # window and softcap, no causal mask with Sq != Sk, rows that see no key
    dict(name="tc-ragged-d80", B=2, N=2, G=2, Sq=300, Sk=300, D=80,
         dtype=BF16, causal=True),
    dict(name="tc-window-softcap", B=1, N=2, G=2, Sq=512, Sk=512, D=128,
         dtype=BF16, causal=True, window=128, softcap=50.0),
    dict(name="tc-full-96x160", B=2, N=1, G=2, Sq=96, Sk=160, D=128,
         dtype=BF16, causal=False),
    dict(name="tc-no-visible-key", B=2, N=2, G=2, Sq=80, Sk=128, D=64,
         dtype=BF16, causal=False, window=32, q_offset=100),
    # bf16 whose head dim the tensor-core kernel does not take: fma kernel
    dict(name="fma-bf16-d20", B=1, N=2, G=2, Sq=64, Sk=64, D=20, dtype=BF16,
         causal=True),
    # the decode kernels: one and eight query heads per kv head; twelve in
    # fp32 (two chunks of six) and twenty in bf16 (two chunks of ten); a
    # split range with a window
    dict(name="decode-g1", B=4, N=4, G=1, Sq=1, Sk=1024, D=128, dtype=BF16,
         causal=True, q_offset=1000),
    dict(name="decode-g8", B=2, N=2, G=8, Sq=1, Sk=640, D=64, dtype=BF16,
         causal=True, q_offset=600),
    dict(name="decode-g12-chunks", B=2, N=1, G=12, Sq=1, Sk=300, D=128,
         dtype=F32, causal=True, q_offset=299),
    dict(name="decode-g20-chunks", B=1, N=2, G=20, Sq=1, Sk=512, D=128,
         dtype=BF16, causal=True, q_offset=511),
    dict(name="decode-split-window", B=1, N=2, G=4, Sq=1, Sk=4096, D=128,
         dtype=BF16, causal=True, q_offset=4000, window=1024),
    # deepseek-v2's MLA: q/k of head dim nope 128 + rope 64 = 192, v of 128,
    # 128 heads each its own kv head (G = 1); the prefill and decode step its
    # serve path gives the kernel, then the smoke spec's 24 / 16 in fp32
    # (the parity phase's float16 runtime reads fp32) and the fp32 instances
    # at 192 / 128
    dict(name="mla-prefill", main=True, B=2, N=128, G=1, Sq=2048, Sk=2048,
         D=192, Dv=128, dtype=BF16, causal=True, probe_library=True),
    dict(name="mla-decode", main=True, B=8, N=128, G=1, Sq=1, Sk=2048, D=192,
         Dv=128, dtype=BF16, causal=True, q_offset=2047, probe_library=True),
    dict(name="mla-smoke-fp32", B=2, N=8, G=1, Sq=24, Sk=24, D=24, Dv=16,
         dtype=F32, causal=True),
    dict(name="mla-smoke-decode-fp32", B=2, N=8, G=1, Sq=1, Sk=64, D=24,
         Dv=16, dtype=F32, causal=True, q_offset=40),
    dict(name="mla-fma-fp32", B=1, N=4, G=1, Sq=130, Sk=130, D=192, Dv=128,
         dtype=F32, causal=True),
    dict(name="mla-decode-fp32-split", B=1, N=4, G=1, Sq=1, Sk=1500, D=192,
         Dv=128, dtype=F32, causal=True, q_offset=1400),
    dict(name="mla-tc-ragged", B=1, N=2, G=2, Sq=200, Sk=200, D=168, Dv=96,
         dtype=BF16, causal=True),
    dict(name="mla-decode-split-bf16", B=1, N=2, G=3, Sq=1, Sk=3000, D=192,
         Dv=128, dtype=BF16, causal=True, q_offset=2900),
    dict(name="dv-lt-d-bf16-d64", B=2, N=2, G=2, Sq=150, Sk=150, D=64, Dv=32,
         dtype=BF16, causal=True),
    dict(name="dv-lt-d-decode-d128", B=2, N=2, G=4, Sq=1, Sk=400, D=128,
         Dv=64, dtype=BF16, causal=True, q_offset=399),
    # granite-34b's MQA decode step (one kv head, 48 query heads: three
    # chunks of 16) and gemma2-27b's local-layer prefill at its published
    # window and softcap over 8192 tokens, so the window masks keys
    dict(name="granite-mqa-decode", main=True, B=8, N=1, G=48, Sq=1, Sk=2048,
         D=128, dtype=BF16, causal=True, q_offset=2047),
    dict(name="gemma2-window-softcap-prefill", main=True, B=1, N=16, G=2,
         Sq=8192, Sk=8192, D=128, dtype=BF16, causal=True, window=4096,
         softcap=50.0),
    # whisper-medium (16 heads x 64, one per kv head): the encoder's unmasked
    # self-attention over 1500 frames, the decoder's causal self-attention
    # over its 448-token context, its cross-attention of 448 queries to the
    # 1500 encoder outputs, and the two decode steps: self over the 448-entry
    # cache and cross over 1500 keys (random here: on the served path the
    # cross caches are zeros, as in the JAX package)
    dict(name="whisper-encoder", main=True, B=2, N=16, G=1, Sq=1500,
         Sk=1500, D=64, dtype=BF16, causal=False),
    dict(name="whisper-self-prefill", main=True, B=2, N=16, G=1, Sq=448,
         Sk=448, D=64, dtype=BF16, causal=True),
    dict(name="whisper-cross-prefill", main=True, B=2, N=16, G=1, Sq=448,
         Sk=1500, D=64, dtype=BF16, causal=False),
    dict(name="whisper-self-decode", main=True, B=8, N=16, G=1, Sq=1, Sk=448,
         D=64, dtype=BF16, causal=True, q_offset=447),
    dict(name="whisper-cross-decode", main=True, B=8, N=16, G=1, Sq=1,
         Sk=1500, D=64, dtype=BF16, causal=False),
    # internvl2-26b's prefill over 256 vision + 2048 text positions (48 / 8
    # heads x 128); jamba's one attention layer in 8 (32 / 8 heads x 128)
    dict(name="internvl2-prefill", main=True, B=2, N=8, G=6, Sq=2304,
         Sk=2304, D=128, dtype=BF16, causal=True),
    dict(name="jamba-prefill", main=True, B=2, N=8, G=4, Sq=2048, Sk=2048,
         D=128, dtype=BF16, causal=True),
    dict(name="jamba-decode", main=True, B=8, N=8, G=4, Sq=1, Sk=2048,
         D=128, dtype=BF16, causal=True, q_offset=2047),
]


def attention_bound(case, mask: torch.Tensor) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate (q and
    out once, each K and V row some query can see once) and operations over
    the peak rate of the input type (two products over the visible pairs:
    2 (D + Dv) each).  A row that sees no key reads every V row and sums
    it."""
    B, N, G, D = case["B"], case["N"], case["G"], case["D"]
    Dv = case.get("Dv", D)
    size = torch.empty((), dtype=case["dtype"]).element_size()
    pairs = int(mask.sum())
    visible_keys = int(mask.any(0).sum())
    blind_rows = int((~mask.any(1)).sum())
    v_rows = case["Sk"] if blind_rows else visible_keys
    nbytes = size * (B * case["Sq"] * N * G * (D + Dv)
                     + B * (visible_keys * D + v_rows * Dv) * N)
    ops = 2 * B * N * G * (D + Dv) * pairs \
        + B * N * G * Dv * case["Sk"] * blind_rows
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[case["dtype"]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tolerance(want: torch.Tensor) -> torch.Tensor:
    """The largest error allowed at each element of ``want``."""
    tol = TOL[want.dtype]
    w = want.float()
    return (tol["absolute"] + tol["rms_share"] * w.square().mean().sqrt()
            + tol["relative"] * w.abs())


def library_attention(case, q, k, v, mask: torch.Tensor):
    """One F.scaled_dot_product_attention call computing the same function,
    or None where there is none (softcap; a row that sees no key, which the
    library gives NaN or zeros and the port the mean of v).  One query row
    sees one run of
    keys, so it is given just that slice of K and V (a view); a window or
    an offset diagonal over several rows goes in as ``attn_mask``.  A
    yardstick for this script only; the package never calls it."""
    if case.get("softcap") or not bool(mask.any(1).all()):
        return None
    B, Sq, N, G, D = q.shape
    Dv = v.shape[-1]
    kw = {}
    if Sq == 1:
        seen = mask[0].nonzero().flatten()
        lo, hi = int(seen[0]), int(seen[-1]) + 1
        require(hi - lo == seen.numel(), "one row sees one run of keys")
        k, v = k[:, lo:hi], v[:, lo:hi]
    elif not bool(mask.all()):
        plain_causal = (case["causal"] and not case.get("window")
                        and not case.get("q_offset", 0))
        kw = dict(is_causal=True) if plain_causal else dict(attn_mask=mask)
    qh = q.reshape(B, Sq, N * G, D).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if G > 1:
        if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
            kw["enable_gqa"] = True
        else:
            kh, vh = (t.repeat_interleave(G, dim=1) for t in (kh, vh))
    require(Dv == vh.shape[-1], "v keeps its head dim")
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)


def library_backend(lib) -> str:
    """Which of PyTorch's attention kernels one library call ran: the names
    of the device kernels torch.profiler records for it (flash, the memory-
    efficient cutlass kernel, cuDNN), else the math path's plain products,
    or "not measured" where the profiler records no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lib()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lib()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    if not names:
        return "not measured"
    for tag, backend in (("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient"), ("cudnn", "cudnn")):
        if any(tag in n.lower() for n in names):
            return backend
    return "math: " + ", ".join(sorted({n[:40] for n in names})[:4])


def attention_inputs(case, seed: int) -> tuple:
    """q, k, v of a case drawn on the card from ``seed``, and the call's
    keywords."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, N, G, D = case["B"], case["N"], case["G"], case["D"]
    Dv = case.get("Dv", D)
    Sq, Sk, dtype = case["Sq"], case["Sk"], case["dtype"]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV,
                           dtype=torch.float32).to(dtype)

    q, k, v = rand(B, Sq, N, G, D), rand(B, Sk, N, D), rand(B, Sk, N, Dv)
    kw = dict(causal=case["causal"], window=case.get("window"),
              softcap=case.get("softcap"), q_offset=case.get("q_offset", 0))
    return q, k, v, kw


# rows whose library call's backend is read once the main paths have run
# (torch.profiler, once started, slows every later launch of the process)
BACKEND_PROBES: list = []


def probe_library_backends() -> None:
    """Fill ``library_backend`` of the rows that asked for it, on inputs
    drawn again from their seeds."""
    while BACKEND_PROBES:
        case, seed, row = BACKEND_PROBES.pop(0)
        q, k, v, kw = attention_inputs(case, seed)
        mask = fa._visible(case["Sq"], case["Sk"], kw["causal"], kw["window"],
                           kw["q_offset"], DEV)
        row["library_backend"] = library_backend(
            library_attention(case, q, k, v, mask))


def check_attention_case(case, seed: int) -> dict:
    q, k, v, kw = attention_inputs(case, seed)
    B, N, G, D = case["B"], case["N"], case["G"], case["D"]
    Dv = v.shape[-1]
    Sq, Sk, dtype = case["Sq"], case["Sk"], case["dtype"]
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    require(fa.launches == before + 1,
            "the wrapper did not count its launch")
    want = fa.flash_attention_plain(q, k, v, **kw)
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{case['name']}: kernel and plain version differ in shape or dtype")
    require(torch.isfinite(got).all(),
            f"{case['name']}: kernel output not finite")
    err = (got.float() - want.float()).abs()
    allowed = tolerance(want)
    require(not (err > allowed).any(),
            f"{case['name']}: kernel disagrees with its plain version: "
            f"max abs err {err.max().item():.3e}, {TOL[dtype]}")

    if Sq == 1 and case["causal"] and kw["q_offset"] > 0:
        # the limit is tight enough to tell a kernel that loses one key
        short = fa.flash_attention_plain(q, k, v, **{**kw, "q_offset":
                                                     kw["q_offset"] - 1})
        require(((short.float() - want.float()).abs() > allowed).any(),
                f"{case['name']}: the tolerance would let a lost key pass")

    variant = fa._variant(q, k, v)
    splits = 1
    boundary_keys = []
    if variant == "decode":
        lo, hi = fa._decode_range(Sk, kw["causal"], kw["window"],
                                  kw["q_offset"])
        g_chunks = -(-G // fa.DECODE_MAX_HEADS[dtype])
        splits = fa.decode_splits(B, N * g_chunks, max(0, hi - lo),
                                  fa.decode_target_blocks(dtype, D))
        split_len = -(-(hi - lo) // splits)
        # a kernel that loses the first key of a split is refused
        boundary_keys = sorted({lo + split_len, lo + (splits - 1) * split_len}
                               ) if splits > 1 else []
    for kb in boundary_keys:
        keep = torch.ones(Sk, dtype=torch.bool, device=DEV)
        keep[kb] = False
        lost_kw = dict(kw)
        if kw["causal"]:          # the same range without key kb
            lost_kw["q_offset"] = kw["q_offset"] - 1
            if kw["window"]:
                lost_kw["window"] = kw["window"] - 1
        lost = fa.flash_attention_plain(q, k[:, keep], v[:, keep], **lost_kw)
        require(((lost.float() - want.float()).abs() > allowed).any(),
                f"{case['name']}: the tolerance would let the lost key {kb} "
                "at a split boundary pass")

    mask = fa._visible(Sq, Sk, kw["causal"], kw["window"], kw["q_offset"], DEV)
    blind_rows = int((~mask.any(1)).sum())
    if blind_rows:
        # the oracle of the JAX package's tests, in [B, H, S, D]
        def bhsd(t):
            return t.reshape(B, t.shape[1], -1, t.shape[-1]).transpose(1, 2)
        oracle = ref.ref_attention(
            bhsd(q), bhsd(k).repeat_interleave(G, dim=1),
            bhsd(v).repeat_interleave(G, dim=1), **kw)
        oracle = oracle.transpose(1, 2).reshape(got.shape)
        o_err = (got.float() - oracle.float()).abs()
        require(not (o_err > tolerance(oracle)).any(),
                f"{case['name']}: a row without a visible key is not "
                f"ref_attention's mean of v (max abs err {o_err.max().item()})")
    bound_ms, bound_by = attention_bound(case, mask)
    lib = library_attention(case, q, k, v, mask)
    if lib:
        lib_err = (lib().transpose(1, 2).reshape(want.shape).float()
                   - want.float()).abs()
        require(not (lib_err > 4 * allowed).any(),
                f"{case['name']}: the library call computes something else "
                f"(max abs err {lib_err.max().item():.3e})")
    dev_ms, ahead = device_ms(lambda: fa.flash_attention(q, k, v, **kw))
    lib_dev_ms, lib_ahead = device_ms(lib) if lib else (None, None)
    row = {
        "shape": case["name"], "main_path": bool(case.get("main")),
        "variant": variant, "splits": splits,
        "split_boundary_keys_checked": boundary_keys,
        "B": B, "N": N, "G": G, "Sq": Sq, "Sk": Sk, "D": D, "Dv": Dv,
        "dtype": str(dtype)[6:], **{k_: v_ for k_, v_ in kw.items() if v_},
        "max_abs_err": err.max().item(),
        "max_err_over_allowed": (err / allowed).max().item(),
        "tolerance": TOL[dtype], "rows_without_visible_key": blind_rows,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
        "device_ms": dev_ms, "device_ms_queued_ahead": ahead,
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw)),
        "library_ms": time_ms(lib) if lib else None,
        "library_device_ms": lib_dev_ms,
        "library_device_ms_queued_ahead": lib_ahead,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    row["bound_share_device"] = bound_ms / dev_ms
    if lib and case.get("probe_library"):
        BACKEND_PROBES.append((case, seed, row))
    if lib:
        row["over_library"] = row["ms"] / row["library_ms"]
        row["over_library_device"] = dev_ms / lib_dev_ms
    return row


def check_strided_cache_view() -> float:
    """The decode path hands the kernel views of a stacked cache
    [layers, B, kv_len, N, D]; a sliced view must give what its copy gives."""
    gen = torch.Generator(device=DEV).manual_seed(99)
    cache = torch.randn((2, 3, 3, 96, 2, 64), generator=gen, device=DEV,
                        dtype=torch.float32).to(BF16)
    q = torch.randn((3, 1, 2, 4, 64), generator=gen, device=DEV,
                    dtype=torch.float32).to(BF16)
    k, v = cache[0, 1][:, 8:72], cache[1, 1][:, 8:72]
    require(not k.is_contiguous(), "the cache slice should be a strided view")
    got = fa.flash_attention(q, k, v, causal=True, q_offset=40)
    want = fa.flash_attention(q, k.contiguous(), v.contiguous(), causal=True,
                              q_offset=40)
    plain = fa.flash_attention_plain(q, k, v, causal=True, q_offset=40)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            "strided view and its copy disagree")
    err = (got.float() - plain.float()).abs()
    require(not (err > tolerance(plain)).any(),
            f"strided view: max abs err {err.max().item()}")
    return err.max().item()


# wkv6, [B, S, N, D] and the chunk C.  Decays as the model draws them,
# w = exp(-exp(dec)) with dec ~ N(0, 1): about 18 % of them are below the
# e^{-80/32} floor, and at the prefill shape a few hundred below 1e-30.  Each
# shape prints the kernel kernels/rwkv6_scan.py:_variant names (decode for
# one step, tiled for more) and, for tiled, its tile (steps, columns).
WKV_CASES = [
    # the two calls the rwkv6-7b serve path makes: its r, k, v are bf16,
    # read as they are and cast on load
    dict(name="prefill", main=True, B=2, S=2048, N=64, D=64, chunk=32,
         dtype=torch.bfloat16),
    dict(name="decode-in-place", main=True, B=8, S=1, N=64, D=64, chunk=1,
         state=True, in_place=True, dtype=torch.bfloat16),
    # the same shapes with fp32 r, k, v
    dict(name="prefill-fp32", B=2, S=2048, N=64, D=64, chunk=32),
    dict(name="decode-in-place-fp32", B=8, S=1, N=64, D=64, chunk=1,
         state=True, in_place=True),
    # a prompt whose length 32 does not divide is one chunk of S
    dict(name="single-chunk-40", B=2, S=40, N=64, D=64, chunk=40, state=True),
    dict(name="single-chunk-1000", B=1, S=1000, N=8, D=64, chunk=1000,
         state=True),
    # a ragged last tile in every chunk (57 = 16 + 16 + 16 + 9); a chunk
    # shorter than the tile, so the tile is cut at every chunk boundary
    dict(name="chunk-57", B=2, S=114, N=8, D=64, chunk=57, state=True),
    dict(name="chunk-8", B=2, S=64, N=8, D=64, chunk=8, state=True),
    # decays below 1e-30 at the first step of a tile and of the sequence
    dict(name="w-below-1e-30", B=2, S=256, N=8, D=64, chunk=32, state=True,
         tiny_w=True),
    # the smoke spec's head dim, and a head dim that is no power of two
    dict(name="d32", B=2, S=64, N=4, D=32, chunk=32, state=True),
    dict(name="d48", B=1, S=96, N=3, D=48, chunk=32, state=True),
    # the decode kernel at one sequence and at the other head dims
    dict(name="decode-b1", B=1, S=1, N=64, D=64, chunk=1, state=True,
         in_place=True),
    dict(name="decode-d32", B=4, S=1, N=8, D=32, chunk=1, state=True),
    dict(name="decode-d48-bf16", B=3, S=1, N=5, D=48, chunk=1, state=True,
         dtype=torch.bfloat16),
    # head dim 128, the widest instance of both kernels, and a head dim
    # between 64 and 128 that the wrapper zero-pads to it
    dict(name="d128", B=2, S=256, N=8, D=128, chunk=32, state=True),
    dict(name="d96", B=1, S=96, N=4, D=96, chunk=32),
    dict(name="decode-d128-bf16", B=4, S=1, N=8, D=128, chunk=1, state=True,
         in_place=True, dtype=torch.bfloat16),
    # head dims above 128: padded to a multiple of 128, the m x m blocks of
    # D = 128 as heads of one launch of the D = 128 instance
    dict(name="d192", B=1, S=128, N=4, D=192, chunk=32, state=True),
    dict(name="d192-bf16", B=1, S=128, N=4, D=192, chunk=32, state=True,
         dtype=torch.bfloat16),
    dict(name="d256", B=2, S=256, N=4, D=256, chunk=32, state=True),
    dict(name="d256-bf16", B=2, S=256, N=4, D=256, chunk=32, state=True,
         dtype=torch.bfloat16),
    dict(name="decode-d256-bf16", B=4, S=1, N=4, D=256, chunk=1, state=True,
         in_place=True, dtype=torch.bfloat16),
    # the state carried across two calls
    dict(name="carry-two-calls", B=2, S=256, N=8, D=64, chunk=32, state=True,
         split=128),
]
# kernel vs plain version: |err| <= absolute + relative * |plain|, on the
# output and on the final state.  The plain version is run in float64 for
# this: in fp32 it (like the TPU kernel) scales r and k by factors up to
# e^{+-80} inside a chunk, which costs it up to 2.6e-4 of (1 + |x|) and grows
# with the chunk (0.86 of a 1e-3 limit at C = 1000 on the card), while a
# one-step walk of the recurrence stays within 2e-5 of (1 + |x|) of the
# float64 function at every chunk size.  The limit is ten times that.  The
# tiled kernel divides only by running products of floored decays (>= e^-80
# over a chunk); its arithmetic in fp32 on the CPU (wkv6_tiled_plain, in
# tests/test_torch_wkv6_tiled.py) stays within 0.05 of this limit.
# Dropping one token's k^T v moves outputs by tens: the script checks that
# the limit refuses that.
WKV_TOL = dict(absolute=2e-4, relative=2e-4)


def wkv_bound(case) -> tuple:
    """(bound_ms, bound_by): 4 D^2 operations per (b, n, step) at the fp32
    rate against the bytes of r, k, v (in their dtype), w and out (fp32)
    once and the state in and out once."""
    B, S, N, D = case["B"], case["S"], case["N"], case["D"]
    esize = torch.empty((), dtype=case.get("dtype", F32)).element_size()
    t_ops = B * S * N * 4 * D * D / PEAK_FLOPS[torch.float32]
    t_bytes = ((3 * esize + 8) * B * S * N * D
               + 2 * 4 * B * N * D * D) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def wkv_tolerance(want: torch.Tensor) -> torch.Tensor:
    return WKV_TOL["absolute"] + WKV_TOL["relative"] * want.abs()


def wkv_inputs(case, seed: int) -> tuple:
    """r, k, v (in the case's dtype), w, u, state0 on the card, from a seed;
    ``tiny_w`` sets decays below 1e-30 at the first step of the second tile
    (and chunk) and at the first step of the sequence."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    B, S, N, D = case["B"], case["S"], case["N"], case["D"]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    dtype = case.get("dtype", F32)
    r, k, v = (rand(B, S, N, D).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rand(B, S, N, D)))
    if case.get("tiny_w"):
        w[:, 32, :, :8] = 1e-35
        w[:, 0, :, 8:16] = 1e-38
    u = rand(N, D)
    s0 = rand(B, N, D, D) if case.get("state") else \
        torch.zeros(B, N, D, D, device=DEV)
    return r, k, v, w, u, s0


def check_wkv_case(case, seed: int) -> dict:
    B, S, N, D, C = case["B"], case["S"], case["N"], case["D"], case["chunk"]
    r, k, v, w, u, s0 = wkv_inputs(case, seed)
    variant = wkv._variant(r)
    before = wkv.launches
    if case.get("split"):
        h = case["split"]
        o1, st1 = wkv.wkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0,
                           chunk=C)
        o2, got_s = wkv.wkv6(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, st1,
                             chunk=C)
        got = torch.cat([o1, o2], dim=1)
        calls = 2
    elif case.get("in_place"):
        cache = s0.clone()
        got, got_s = wkv.wkv6(r, k, v, w, u, cache, chunk=C, state_out=cache)
        require(got_s is cache, "the state was not written in place")
        calls = 1
    else:
        got, got_s = wkv.wkv6(r, k, v, w, u, s0, chunk=C)
        calls = 1
    torch.cuda.synchronize()
    require(wkv.launches == before + calls,
            "the wrapper did not count its launches")
    want, want_s = wkv.wkv6_plain(r, k, v, w, u, s0, chunk=C,
                                  dtype=torch.float64)
    plain, plain_s = wkv.wkv6_plain(r, k, v, w, u, s0, chunk=C)
    name = case["name"]
    require(torch.isfinite(got).all() and torch.isfinite(got_s).all(),
            f"wkv6 {name}: kernel output not finite")
    err = (got.double() - want).abs()
    err_s = (got_s.double() - want_s).abs()
    allowed, allowed_s = wkv_tolerance(want), wkv_tolerance(want_s)
    require(not (err > allowed).any() and not (err_s > allowed_s).any(),
            f"wkv6 {name} ({variant}): kernel disagrees with its plain "
            f"version: max abs err {err.max().item():.3e} (out), "
            f"{err_s.max().item():.3e} (state), {WKV_TOL}")

    # a kernel that drops one token's k^T v is refused by this limit
    k_lost = k.clone()
    k_lost[:, S // 2] = 0
    lost, lost_s = wkv.wkv6_plain(r, k_lost, v, w, u, s0, chunk=C,
                                  dtype=torch.float64)
    require(((lost - want).abs() > allowed).any()
            or ((lost_s - want_s).abs() > allowed_s).any(),
            f"wkv6 {name}: the tolerance would let a lost token pass")

    def run_kernel():
        if case.get("in_place"):
            wkv.wkv6(r, k, v, w, u, cache, chunk=C, state_out=cache)
        else:
            wkv.wkv6(r, k, v, w, u, s0, chunk=C)

    bound_ms, bound_by = wkv_bound(case)
    floor = np.exp(-80.0 / C)
    dev_ms, ahead = device_ms(run_kernel)
    row = {
        "shape": name, "main_path": bool(case.get("main")),
        "variant": variant,
        "tile": list(wkv.tile_config(wkv.head_dim_instance(D), C))
        if variant == "tiled" else None,
        "instance": wkv.head_dim_instance(D),
        "blocks": wkv.head_dim_blocks(D) ** 2 if D > wkv.BLOCK else 1,
        "B": B, "S": S, "N": N, "D": D, "chunk": C, "calls": calls,
        "dtype": str(r.dtype)[6:],
        "max_abs_err": max(err.max().item(), err_s.max().item()),
        "max_abs_err_out": err.max().item(),
        "max_abs_err_state": err_s.max().item(),
        "max_err_over_allowed": max((err / allowed).max().item(),
                                    (err_s / allowed_s).max().item()),
        "max_abs_out": want.abs().max().item(),
        "tolerance": WKV_TOL, "held_against": "wkv6_plain in float64",
        "plain_fp32_max_err_over_allowed": max(
            ((plain.double() - want).abs() / allowed).max().item(),
            ((plain_s.double() - want_s).abs() / allowed_s).max().item()),
        "lost_token_max_change": (lost - want).abs().max().item(),
        "share_w_below_floor": (w < floor).float().mean().item() if C > 1
        else 0.0,
        "count_w_below_1e-30": int((w < 1e-30).sum()),
        "ms": time_ms(run_kernel),
        "device_ms": dev_ms, "device_ms_queued_ahead": ahead,
        "plain_ms": time_ms(lambda: wkv.wkv6_plain(r, k, v, w, u, s0,
                                                   chunk=C)),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    row["bound_share_device"] = bound_ms / dev_ms
    return row


# cost_reduce, out[b, e] = sum_t x[b, t] w[e, t]: x [B, T], w [E, T].  The
# main rows are the calls the batched sweep makes: one per class call, x the
# [B, K] slot durations of B configs (positive), w the stacked [2G, K]
# busy-group rows (every slot in exactly one row: its group's compute row or
# its comm row), at the sweep's batches (1, 3 and 18 configs at pp = 1, 2G =
# 4; 3 configs at pp = 2, 2G = 12).  The api phase's two main paths make the
# same kind of call at other sizes: its train sweep's largest batch and
# longest table, and its serving sweep's prefill tables (one config, K of
# 765-1371 slots, 2G up to 24).  The analysis phase's deepseek-v2-236b sweep
# makes longer ones (K of 9 339-16 002, B up to 6, 2G up to 48): its largest
# batch at each 2G.  Then the compute rows alone at B = 64
# (half the slots in no row), a large batch, fp32, a strided view, a half x,
# more than one e-tile, the reference's four shapes (tests/test_kernels.py)
# in fp32 and fp64, and integer counts.
F64, F16 = torch.float64, torch.float16
COST_CASES = [
    *[dict(name=f"{path}-{b}x{e}x{t}", main=True, B=b, E=e, T=t, dtype=F64,
           rows="busy")
      for path, b, e, t in (("sweep", 1, 4, 4189), ("sweep", 3, 4, 4189),
                            ("sweep", 18, 4, 4189), ("sweep", 3, 12, 4191),
                            ("api", 9, 4, 4952), ("api", 1, 4, 6157),
                            ("api", 3, 12, 5839), ("serving", 1, 4, 765),
                            ("serving", 1, 12, 1209),
                            ("serving", 1, 24, 768), ("dsv2", 6, 4, 15870),
                            ("dsv2", 4, 12, 13711), ("dsv2", 2, 24, 15994),
                            ("dsv2", 1, 48, 16002))],
    dict(name="path-pp1", B=64, E=2, T=4189, dtype=F64, rows="membership"),
    dict(name="path-pp2", B=64, E=6, T=4191, dtype=F64, rows="membership"),
    dict(name="large-1024x12x4191", B=1024, E=12, T=4191, dtype=F64,
         rows="busy"),
    dict(name="busy-f32", B=64, E=8, T=4096, dtype=F32, rows="busy"),
    dict(name="row-stride-f64", B=18, E=4, T=4189, dtype=F64, rows="busy",
         row_stride=4200),
    dict(name="half-x-f16", B=18, E=4, T=4189, dtype=F16, rows="busy"),
    dict(name="pp8-48-rows", B=3, E=48, T=4195, dtype=F64, rows="busy"),
    *[dict(name=f"ref-{b}x{e}x{t}", B=b, E=e, T=t, dtype=dt, rows="normal")
      for dt in (F32, F64)
      for b, e, t in ((1, 1, 1), (4, 7, 33), (128, 128, 128), (130, 257, 140))],
    # integer counts (0/1/k rows, integer x): the sums are exact
    dict(name="counts-f32", B=130, E=9, T=4189, dtype=F32, rows="counts"),
    dict(name="counts-f64", B=64, E=6, T=4191, dtype=F64, rows="counts"),
]
# kernel vs plain version.  fp32: the reference's 1e-4 + 1e-4 |x|.  fp64:
# 1e-12 of sum_t |x||w| per output (the two differ only in the order of the
# sum; 4 200 terms move a float64 sum by ~1e-13 of that at most).  A half x
# is summed in fp32 and rounded once: the fp32 limit plus one ulp of the
# half type.  Counts: exact.  Dropping one t term is refused by each limit:
# the script checks.
COST_TOL = {F32: dict(absolute=1e-4, relative=1e-4),
            F16: dict(absolute=1e-4, relative=1e-4 + 2.0 ** -10),
            F64: dict(scale=1e-12)}


def cost_inputs(case, gen):
    B, E, T, dtype = case["B"], case["E"], case["T"], case["dtype"]
    rows = case["rows"]
    if rows == "normal":
        return (torch.randn((B, T), generator=gen, device=DEV, dtype=F64),
                torch.randn((E, T), generator=gen, device=DEV, dtype=F64))
    if rows in ("membership", "busy"):
        x = torch.rand((B, T), generator=gen, device=DEV, dtype=F64) * 1e-3
        group = torch.randint(0, E, (T,), generator=gen, device=DEV)
        keep = torch.rand((T,), generator=gen, device=DEV) < 0.5
        w = torch.zeros((E, T), device=DEV, dtype=F64)
        w[group, torch.arange(T, device=DEV)] = \
            1.0 if rows == "busy" else keep.to(F64)
        return x, w
    x = torch.randint(0, 1000, (B, T), generator=gen, device=DEV).to(F64)
    w = torch.randint(0, 4, (E, T), generator=gen, device=DEV).to(F64)
    w[w == 3] = 0                                  # mostly 0/1, some 2
    return x, w


def cost_allowed(want, x, w):
    tol = COST_TOL[want.dtype]
    if want.dtype == F64:
        return tol["scale"] * (x.abs() @ w.abs().T)
    return tol["absolute"] + tol["relative"] * want.double().abs()


def cost_bound(case, w) -> tuple:
    """(bound_ms, bound_by): x, w read once and out written once against
    the operations these inputs need, 2 B nnz(w) (a zero of a membership row
    needs none), at the peak rate of the type."""
    B, E, T, dtype = case["B"], case["E"], case["T"], case["dtype"]
    size = dtype.itemsize
    t_bytes = (B * T + E * T + B * E) * size / PEAK_BYTES_PER_S
    t_ops = 2 * B * int(torch.count_nonzero(w)) / PEAK_FLOPS[
        cr._compute_dtype(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_cost_case(case, seed: int) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x64, w64 = cost_inputs(case, gen)
    dtype, name = case["dtype"], case["name"]
    x, w = x64.to(dtype).contiguous(), w64.to(dtype).contiguous()
    if "row_stride" in case:             # the same values, rows further apart
        wide = torch.zeros((case["B"], case["row_stride"]), dtype=dtype,
                           device=DEV)
        x = wide[:, :case["T"]].copy_(x)
    before = cr.launches
    got = cr.cost_reduce_bet(x, w)
    again = cr.cost_reduce_bet(x, w)
    torch.cuda.synchronize()
    require(cr.launches == before + 2, "the wrapper did not count its launches")
    require(torch.equal(got, again), f"cost_reduce {name}: two runs differ")
    want = cr.cost_reduce_plain(x, w)
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"cost_reduce {name}: kernel and plain version differ in shape "
            f"or dtype")
    require(torch.isfinite(got).all(), f"cost_reduce {name}: not finite")
    err = (got.double() - want.double()).abs()
    if case["rows"] == "counts":
        exact = (x.double() @ w.double().T).to(dtype)
        require(torch.equal(got, exact),
                f"cost_reduce {name}: integer counts not exact "
                f"(max abs err {(got - exact).abs().max().item()})")
        allowed = torch.zeros_like(err)
        share = 0.0
    else:
        allowed = cost_allowed(want, x, w)
        require(not (err > allowed).any(),
                f"cost_reduce {name}: kernel disagrees with its plain "
                f"version: max abs err {err.max().item():.3e}, "
                f"{COST_TOL[dtype]}")
        share = (err / allowed).max().item()
    # a kernel that drops one t term is refused by this limit
    t0 = int((x.abs().amax(0) * w.abs().amax(0)).argmax())
    x_lost = x.clone()
    x_lost[:, t0] = 0
    lost = cr.cost_reduce_plain(x_lost, w).double()
    require(((lost - want.double()).abs() > allowed).any(),
            f"cost_reduce {name}: the tolerance would let a lost term pass")
    bound_ms, bound_by = cost_bound(case, w)
    slices, e_tile = cr._split(case["B"], case["E"], case["T"])
    dev_ms, ahead = device_ms(lambda: cr.cost_reduce_bet(x, w))
    lib_dev_ms, lib_ahead = device_ms(lambda: torch.matmul(x, w.T))
    return {
        "shape": name, "main_path": bool(case.get("main")),
        "B": case["B"], "E": case["E"], "T": case["T"],
        "dtype": str(dtype)[6:], "rows": case["rows"],
        "split": {"slices": slices, "e_tile": e_tile,
                  "slice_len": cr.slice_len(case["T"], slices),
                  "warps": cr._warps(case["B"]), "rows_per_warp": cr.ROWS},
        "max_abs_err": err.max().item(), "max_err_over_allowed": share,
        "tolerance": "exact" if case["rows"] == "counts" else COST_TOL[dtype],
        "deterministic": True,
        "lost_term_max_change": (lost - want.double()).abs().max().item(),
        "device_ms": dev_ms, "device_ms_queued_ahead": ahead,
        "ms": time_ms(lambda: cr.cost_reduce_bet(x, w)),
        "plain_ms": time_ms(lambda: cr.cost_reduce_plain(x, w)),
        "library_device_ms": lib_dev_ms,
        "library_device_ms_queued_ahead": lib_ahead,
        "library_ms": time_ms(lambda: torch.matmul(x, w.T)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share_device": bound_ms / dev_ms,
    }


def kernel_entry(name: str, replaces: str, shapes: list, **extra) -> dict:
    """One kernel's entry of the ``kernels`` line; the top-level numbers are
    those of its main path's prefill shape (the first)."""
    head = shapes[0]
    return {
        "name": name, "route": "cuda",
        "source": SOURCES[name],
        "replaces": replaces,
        "launches": 0,                       # filled in by the serve phase
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        **{k: head[k] for k in ("device_ms", "library_device_ms")
           if k in head},
        "shape": head["shape"], **extra, "shapes": shapes,
    }


def phase_kernels() -> list:
    attention = [check_attention_case(c, seed=i)
                 for i, c in enumerate(ATTENTION_CASES)]
    strided_err = check_strided_cache_view()
    scans = [check_wkv_case(c, seed=100 + i) for i, c in enumerate(WKV_CASES)]
    costs = [check_cost_case(c, seed=200 + i) for i, c in enumerate(COST_CASES)]
    # the D_v < D instance (MLA) with the numbers of its own main rows;
    # its launches are the deepseek-v2 path's, filled in by the serve phase
    mla = {r["shape"]: r for r in attention}
    mla_instance = {
        "launches": 0, "path": "serve deepseek-v2-236b",
        **{k: mla["mla-prefill"][k]
           for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "device_ms", "library_device_ms")},
        "shape": "mla-prefill", "decode_shape": "mla-decode",
        "decode": {k: mla["mla-decode"][k]
                   for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")},
    }
    return [
        kernel_entry("flash_attention",
                     "src/repro/kernels/flash_attention.py:80", attention,
                     strided_view_max_abs_err=strided_err,
                     instances={"dv<d (mla, d 192, dv 128)": mla_instance}),
        kernel_entry("wkv6", "src/repro/kernels/rwkv6_scan.py:80", scans,
                     library="none: no single PyTorch call computes wkv6"),
        kernel_entry("cost_reduce", "src/repro/kernels/cost_reduce.py:49",
                     costs, library="torch.matmul(x, w.T)"),
    ]


# ---------------------------------------------------------------------------
# serve: the main paths
# ---------------------------------------------------------------------------

def device_us(e) -> float:
    """Device time of a torch.profiler event row, microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


# the port's functions a profile times apart (each runs inside a
# torch.profiler range of its own name while the profile records), and the
# device kernels it sums by family, from their names
PROFILED_FUNCTIONS = ("mamba_layer", "_ssm_scan", "_causal_conv", "moe_ffn",
                      "moe_dispatch", "moe_combine")
KERNEL_FAMILIES = {"flash_attention": ("flash",), "wkv6": ("wkv6",),
                   "cublas": ("gemm", "nvjet", "cutlass", "xmma")}


@contextlib.contextmanager
def profiled_functions():
    """Wrap each of ``PROFILED_FUNCTIONS`` of ``models.layers`` in a range of
    its name, for one profile; the functions are restored after it."""
    from torch.profiler import record_function
    from repro_torch.models import layers
    saved = {name: getattr(layers, name) for name in PROFILED_FUNCTIONS}

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(layers, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(layers, name, fn)


def kernel_events(prof) -> list:
    """The ``key_averages`` rows of device kernels.  The device-side rows of
    the ranges ``profiled_functions`` opens (their spans on the device,
    idle gaps included) are no kernels and are left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0
            and e.key not in PROFILED_FUNCTIONS]


def device_split(prof, events, busy_ms: float, per: int = 1) -> dict:
    """Device ms (per ``per`` steps) and share of the busy time of each
    profiled function that ran (the kernels of every op under its range)
    and of each kernel family."""
    ranges = {name: 0.0 for name in PROFILED_FUNCTIONS}
    for e in prof.events():
        us = sum(k.duration for k in e.kernels if k.name not in ranges)
        parent = e.cpu_parent
        while us and parent is not None:
            if parent.name in ranges:
                ranges[parent.name] += us
            parent = parent.cpu_parent
    families = {fam: sum(device_us(e) for e in events
                         if any(t in e.key.lower() for t in tags))
                for fam, tags in KERNEL_FAMILIES.items()}
    out = {}
    for name, us in {**ranges, **families}.items():
        if us > 0:
            ms = us / 1e3 / per
            out[name] = {"ms": ms, "share_of_busy": ms / busy_ms}
    return out


def profile_decode(spec, rt, params, steps: int = 4) -> dict:
    """Where a decode step's time goes (``--profile``): a full 8-slot engine
    takes 16 steps on the host's clock, then ``steps`` more under
    torch.profiler.  The device-busy time per step comes from the trace; the
    idle share holds it against the step time of those 16 steps, so both
    numbers are one engine's in one run."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(spec, rt, params, batch_slots=8, kv_len=2048, device=DEV)
    rng = np.random.RandomState(7)
    for rid in range(8):
        eng.submit(Request(rid=rid, prompt=rng.randint(1, spec.vocab, size=64),
                           max_new=16))
    eng.run(max_steps=4)                                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(max_steps=16)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 16
    with profiled_functions(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run(max_steps=steps)
        torch.cuda.synchronize()

    # kernel events only: the CPU-side op rows repeat their kernels' time
    events = kernel_events(prof)
    busy_ms = sum(device_us(e) for e in events) / 1e3 / steps
    if not events:
        return {"device_busy_ms_per_step": "not measured",
                "reason": "the profiler recorded no device time"}
    top = sorted(events, key=device_us, reverse=True)[:8]
    return {
        "steps": steps, "device_busy_ms_per_step": busy_ms,
        "step_ms_unprofiled_same_engine": step_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "device_kernels_per_step": sum(e.count for e in events) / steps,
        "device_ms_per_step_by_part": device_split(prof, events, busy_ms,
                                                   steps),
        "top_device_ms_per_step": [
            {"name": e.key[:60], "ms": device_us(e) / 1e3 / steps,
             "calls": e.count / steps} for e in top],
    }


def timed_prefill(prefill, params, tokens) -> tuple:
    """One prefill on the host's clock, ending in a sync -> (logits, {ms,
    what else the host did meanwhile: the caching allocator's new device
    allocations and its retries (a retry frees cached blocks after a
    sync), and the milliseconds Python's garbage collector ran})."""
    pauses = []

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t0 = time.perf_counter()
        else:
            pauses.append((time.perf_counter() - on_gc.t0) * 1e3)

    before = torch.cuda.memory_stats()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = prefill(params, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        gc.callbacks.remove(on_gc)
    after = torch.cuda.memory_stats()

    def grew(key):
        return after.get(key, 0) - before.get(key, 0)

    return logits, {"ms": ms, "device_mallocs": grew("num_device_alloc"),
                    "alloc_retries": grew("num_alloc_retries"),
                    "gc_ms": sum(pauses)}


def profile_prefill(prefill, params, tokens, kernel: str) -> dict:
    """Where a warm [2, 2048] prefill's time goes (``--profile``): one
    prefill under torch.profiler; its wall time on the host beside the
    device-busy time and the device time of the model's kernel in it."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        prefill(params, tokens)                          # warm-up
    torch.cuda.synchronize()
    with profiled_functions(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        t0 = time.perf_counter()
        prefill(params, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = kernel_events(prof)
    if not events:
        return {"device_busy_ms": "not measured",
                "reason": "the profiler recorded no device time"}
    busy_ms = sum(device_us(e) for e in events) / 1e3
    tag = {"wkv6": "wkv6", "flash_attention": "flash"}[kernel]
    mine = [e for e in events if tag in e.key]
    top = sorted(events, key=device_us, reverse=True)[:8]
    return {
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        f"{kernel}_device_ms": sum(device_us(e) for e in mine) / 1e3,
        f"{kernel}_kernel_launches": sum(e.count for e in mine),
        "device_ms_by_part": device_split(prof, events, busy_ms),
        "top_device_ms": [{"name": e.key[:60], "ms": device_us(e) / 1e3,
                           "calls": e.count} for e in top],
    }


# each served model: its published (layers, d_model, d_ff, vocab), and the
# kernel its path runs (``flash_launches``: how often).  ``layers``: the
# depth served where the published one is cut (reduced): deepseek-v2-236b's
# 60 layers are 471 GB in bf16, granite-34b's 88 are 94.5 GB, jamba's 32 are
# 103 GB, none fits one 80 GB card (jamba at 16 leaves no margin for init's
# fp32 draw of a layer and the prefill's fp32 scan tensors); gemma2-27b's 46
# would hold the phase as long as two more full-depth models.
# ``long_prefill``: one more [1, S] prefill, so that gemma2's 4096-key window
# masks keys.  ``kv_len`` / ``prefill_len``: whisper's decoder context is
# 448 tokens.  ``frames`` / ``vision``: the encoder's frame embeddings and
# the VLM's patch embeddings [2, n, d_model] the prefill takes (the configs'
# stubs), drawn from numpy with a seed.
SERVED = {
    "qwen3-14b": dict(widths=(40, 5120, 17408, 151936), kernel="flash_attention"),
    "rwkv6-7b": dict(widths=(32, 4096, 14336, 65536), kernel="wkv6"),
    "minitron-8b": dict(widths=(32, 4096, 16384, 256000),
                        kernel="flash_attention"),
    "deepseek-moe-16b": dict(widths=(28, 2048, 10944, 102400),
                             kernel="flash_attention"),
    "deepseek-v2-236b": dict(widths=(60, 5120, 12288, 102400), layers=4,
                             kernel="flash_attention"),
    "gemma2-27b": dict(widths=(46, 4608, 36864, 256000), layers=8,
                       kernel="flash_attention", long_prefill=8192),
    "granite-34b": dict(widths=(88, 6144, 24576, 49152), layers=8,
                        kernel="flash_attention"),
    "jamba-v0.1-52b": dict(widths=(32, 4096, 14336, 65536), layers=8,
                           kernel="flash_attention"),
    "whisper-medium": dict(widths=(24, 1024, 4096, 51865),
                           kernel="flash_attention", kv_len=448,
                           prefill_len=448, frames=1500),
    "internvl2-26b": dict(widths=(48, 6144, 16384, 92553),
                          kernel="flash_attention", vision=256),
}


def flash_launches(spec) -> tuple:
    """(per decode step, per prefill) launches of the attention kernel: one
    per attention layer, one per cross-attention layer (every decoder layer
    of an encoder-decoder), and in the prefill one per encoder layer."""
    attn = sum(lm._slot_kind(spec, l)["mixer"] == "attn"
               for l in range(spec.n_layers))
    cross = spec.n_layers if spec.encoder_layers else 0
    return attn + cross, spec.encoder_layers + attn + cross


def tree_params(spec) -> float:
    """Parameters of the model's tree: the spec's count, plus the decoder's
    cross-attention (one per layer), which ``ModelSpec.params`` leaves out."""
    cross = (spec.n_layers * 2 * spec.d_model * spec.head_dim
             * (spec.n_heads + spec.n_kv_heads) if spec.encoder_layers else 0)
    return spec.params() + cross


def _named_leaves(tree, key=None):
    """(dict key, tensor) of every leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, key)
    else:
        yield key, tree


def phase_serve(name: str, kernels: list, with_profile: bool = False) -> dict:
    from repro_torch.models.convert import FP32_LEAVES
    spec = get_arch(name).spec
    rt = RuntimeCfg()                    # bf16 params and compute, the kernels
    served = SERVED[name]
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == served["widths"], f"not the published {name}")
    published_layers = spec.n_layers
    if "layers" in served:
        spec = dataclasses.replace(spec, n_layers=served["layers"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(spec, rt, gen, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    named = list(_named_leaves(params))
    n_params = sum(t.numel() for _, t in named)
    require(all(t.is_cuda and t.dtype == (torch.float32 if k in FP32_LEAVES
                                          else torch.bfloat16)
                for k, t in named),
            "a parameter is not bf16 on the card (the MoE router and "
            "Mamba's A_log fp32)")
    fp32_leaves = sorted({k for k, t in named if t.dtype == torch.float32})
    require(abs(n_params - tree_params(spec)) / tree_params(spec) < 0.01,
            f"{n_params} parameters, the spec counts {tree_params(spec):.0f}")

    slots, n_req, max_new = 8, 16, 16
    kv_len = served.get("kv_len", 2048)
    prefill_len = served.get("prefill_len", 2048)
    engine = Engine(spec, rt, params, batch_slots=slots, kv_len=kv_len,
                    device=DEV)
    rng = np.random.RandomState(0)
    prompt_tokens = 0
    for rid in range(n_req):
        prompt = rng.randint(1, spec.vocab, size=rng.randint(16, 65))
        prompt_tokens += len(prompt)
        engine.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    prefill_tokens = torch.from_numpy(
        rng.randint(0, spec.vocab, size=(2, prefill_len))).to(DEV)
    long_tokens = torch.from_numpy(rng.randint(
        0, spec.vocab, size=(1, served["long_prefill"]))).to(DEV) \
        if "long_prefill" in served else None
    # the encoder's frames / the VLM's patch embeddings of the two prompts
    prefix = {key: torch.from_numpy(rng.standard_normal(
        (2, served[key], spec.d_model)).astype(np.float32)).to(DEV)
        for key in ("frames", "vision") if key in served}
    sv = served.get("vision", 0)

    def prefill(p, tokens):
        """The prefill entry: lm.forward with the frames / vision prefix of
        as many prompts as ``tokens`` has rows -> logits [B, Sv + S, V]."""
        return lm.forward(p, tokens, spec, rt,
                          **{k: t[:tokens.shape[0]] for k, t in prefix.items()})

    # ---- the main path, with every launch count at 0 just before ----
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(max_steps=kv_len)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    logits, first = timed_prefill(prefill, params, prefill_tokens)
    long_logits = long_info = None
    if long_tokens is not None:
        long_logits, long_info = timed_prefill(prefill, params, long_tokens)
    counts = {k: module.launches for k, module in COUNTERS.items()}
    wkv_variants = dict(wkv.launches_by_variant)
    # ---- read just after ----

    require(len(done) == n_req,
            f"served {len(done)}/{n_req}")
    for r in done:
        require(len(r.out) == max_new,
                f"req {r.rid}: {len(r.out)} tokens")
        require(all(0 <= t < spec.vocab for t in r.out),
                f"req {r.rid}: {r.out}")
    require(logits.shape == (2, sv + prefill_len, spec.vocab),
            f"prefill logits have shape {tuple(logits.shape)}")
    require(torch.isfinite(logits[:, -1]).all(),
            "prefill logits not finite")
    del logits
    prefills = 1
    if long_logits is not None:
        require(long_logits.shape == (1, served["long_prefill"], spec.vocab)
                and bool(torch.isfinite(long_logits[:, -1]).all()),
                "the long prefill's logits are not finite of shape [1,S,V]")
        del long_logits
        prefills = 2
    kernel = served["kernel"]
    per_step, per_prefill = flash_launches(spec)
    if kernel == "flash_attention":
        expected = engine.steps * per_step + prefills * per_prefill
        require(counts[kernel] == expected,
                f"{kernel} launched {counts[kernel]} times, expected "
                f"{engine.steps} steps x {per_step} + {prefills} prefills x "
                f"{per_prefill} = {expected}")
    require(all(n == 0 for k, n in counts.items() if k != kernel),
            f"{name} launched another model's kernel: {counts}")
    if kernel == "wkv6":
        # the rule: one launch per layer; every engine step is one token
        # (decode), the [2, 2048] prefill is 2048 steps (tiled)
        per_step = per_prefill = spec.n_layers
        require(counts[kernel] == (engine.steps + prefills) * spec.n_layers,
                f"wkv6 launched {counts[kernel]} times, expected "
                f"({engine.steps} steps + {prefills} prefills) x "
                f"{spec.n_layers}")
        predicted = {"decode": engine.steps * spec.n_layers,
                     "tiled": spec.n_layers}
        require(wkv_variants == predicted,
                f"wkv6 launches by variant {wkv_variants}, the rule predicts "
                f"{predicted}")
        extra_counts = {"wkv6_launches_by_variant": wkv_variants}
    else:
        extra_counts = {}
    # ``launches``: the sum over the served models that run the kernel,
    # each model's own run beside it
    entry = next(k for k in kernels if k["name"] == kernel)
    entry.setdefault("launches_by_path", {})[f"serve {name}"] = counts[kernel]
    entry["launches"] = sum(entry["launches_by_path"].values())
    for instance in entry.get("instances", {}).values():
        if instance["path"] == f"serve {name}":
            instance["launches"] = counts[kernel]

    # three more prefills, now warm: every reading, and their median as the
    # time that is reported
    warm = [timed_prefill(prefill, params, prefill_tokens)[1]
            for _ in range(3)]
    warm_ms = [w.pop("ms") for w in warm]
    generated = sum(len(r.out) for r in done)
    extra = dict(extra_counts)
    if with_profile:
        extra["profile"] = profile_decode(spec, rt, params)
        extra["profile_prefill"] = profile_prefill(prefill, params,
                                                   prefill_tokens, kernel)
    return {
        **extra,
        "model": spec.name, "layers": spec.n_layers, "d_model": spec.d_model,
        "published_layers": published_layers,
        "reduced": ([f"depth {spec.n_layers} of {published_layers} layers"]
                    if spec.n_layers != published_layers else []),
        "params": n_params, "dtype": "bfloat16", "fp32_leaves": fp32_leaves,
        "init_s": init_s,
        "slots": slots, "kv_len": kv_len, "requests": n_req,
        "served": len(done), "max_new": max_new,
        "prompt_tokens": prompt_tokens, "generated_tokens": generated,
        "decode_steps": engine.steps,
        "decode_ms_per_step": decode_s * 1e3 / engine.steps,
        "tokens_per_s": (prompt_tokens + generated) / decode_s,
        "generated_tokens_per_s": generated / decode_s,
        **({"long_prefill_shape": [1, served["long_prefill"]],
            "long_prefill_ms": long_info.pop("ms"),
            "long_prefill_host_events": long_info} if long_info else {}),
        "prefill_shape": [2, prefill_len],
        **({"prefix": {k: list(t.shape) for k, t in prefix.items()}}
           if prefix else {}),
        "prefill_positions": sv + prefill_len,
        "prefill_first_ms": first.pop("ms"),
        "prefill_ms": float(np.median(warm_ms)),
        "prefill_warm_ms_readings": warm_ms,
        "prefill_host_events": [first, *warm],
        "kernel": kernel, "launches": counts,
        "launches_per_decode_step": per_step,
        "launches_per_prefill": per_prefill, "prefills_counted": prefills,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_request_tokens": done[0].out[:8],
    }


# ---------------------------------------------------------------------------
# sweep: the generator's design-space sweep on the batched backend
# ---------------------------------------------------------------------------

# qwen3-14b's published spec, a training step of 256 x 4096 tokens, every
# power-of-two (dp, tp, cp, pp) factorisation of 64 devices with up to 8
# pipeline stages, 1 or 8 microbatches, 1f1b.  H100_HGX is a flat profile, so
# every point evaluates on the batched backend (a topology profile such as
# H100_HGX_POD would send each one to the per-config compiled path).
SWEEP = dict(arch="qwen3-14b", batch=256, seq=4096, world=64,
             enum=dict(max_pp=8, microbatches=(1, 8), schedule="1f1b"))
# the batched backend against the compiled one: the reference's parity
# budget (tests/test_batched_parity.py); the card against the CPU: both run
# the same float64 arithmetic, apart from the order of index_add_'s atomic
# sums and of the matmuls' sums on the card
SWEEP_REL = 1e-6
CARD_VS_CPU_REL = 1e-10
SIM_FIELDS = ("step_time", "compute_time", "comm_time")
MEM_FIELDS = ("weights", "grads", "opt_states", "master_params",
              "peak_activation", "recompute_extra", "peak_bytes")


def _worst(points, reference):
    """Largest error of ``points`` against ``reference`` (a dict by label),
    as tests/test_batched_parity.py measures it: relative for step,
    compute, comm time and the memory terms; exposed comm (a difference of
    near-equal spans) relative to the step time; the bubble fraction
    absolute."""
    worst = 0.0
    for p in points:
        q = reference[p.label]
        for f in SIM_FIELDS:
            a, b = getattr(q.sim, f), getattr(p.sim, f)
            worst = max(worst, abs(a - b) / max(abs(a), 1e-30))
        worst = max(worst, abs(q.sim.exposed_comm - p.sim.exposed_comm)
                    / q.sim.step_time,
                    abs(q.sim.bubble_fraction - p.sim.bubble_fraction))
        for f in MEM_FIELDS:
            a, b = getattr(q.mem, f), getattr(p.mem, f)
            worst = max(worst, abs(a - b) / max(abs(a), 1e-30))
        require(q.mem.inflight_factor == p.mem.inflight_factor
                and q.sim.schedule == p.sim.schedule,
                f"{p.label}: inflight factor or schedule differ")
    return worst


def _class_call_split(prof, calls: int) -> dict:
    """Host seconds per class call from the spans of one evaluate_many:
    the scan loop, the cost_reduce call, the replay, the rest."""
    tot = prof.totals()

    def total(name):
        return tot.get(name, {}).get("total_s", 0.0)
    call = total("batched.class_call")
    parts = {"scan": total("batched.scan"),
             "cost_reduce": total("batched.cost_reduce"),
             "replay": total("batched.replay")}
    parts["rest"] = call - sum(parts.values())
    return {"class_call_s": call / calls,
            **{f"{k}_s": v / calls for k, v in parts.items()},
            "scan_share": parts["scan"] / call if call else None,
            "outside_class_calls_s": (total("batched.evaluate_many") - call)
            / calls}


def profile_sweep(bengine, cfgs, hw) -> dict:
    """Device-busy time and idle share of one warm evaluate_many, from
    torch.profiler (``--profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bengine.evaluate_many(cfgs, hw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    if not events:
        return {"device_busy_s": "not measured",
                "reason": "the profiler recorded no device time"}
    busy = sum(device_us(e) for e in events) / 1e6
    top = sorted(events, key=device_us, reverse=True)[:8]
    ours = [e for e in events if "cost_reduce_kernel" in e.key]
    calls = sum(e.count for e in ours)
    return {"cost_reduce_device_ms_per_launch":
            sum(device_us(e) for e in ours) / 1e3 / calls if calls else None,
            "cost_reduce_launches_traced": calls,
            "wall_s_profiled": wall, "device_busy_s": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "device_kernels": sum(e.count for e in events),
            "top_device_s": [{"name": e.key[:60], "s": device_us(e) / 1e6,
                              "calls": e.count} for e in top]}


def phase_sweep(kernels: list, with_profile: bool = False) -> dict:
    from repro_torch.core import (H100_HGX, CompiledBackend, bind_env,
                                  build_graph, total_layers)
    from repro_torch.core.batched import BatchedBackend
    from repro_torch.obs import spans
    spec = get_arch(SWEEP["arch"]).spec
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == SERVED[SWEEP["arch"]]["widths"], "not the published qwen3-14b")
    world, enum = SWEEP["world"], SWEEP["enum"]
    env = bind_env(spec, batch=SWEEP["batch"], seq=SWEEP["seq"], mode="train")
    t0 = time.perf_counter()
    src = build_graph(spec, mode="train")
    assemble_s = time.perf_counter() - t0

    def build():
        return src.clone().graph
    n_layers = total_layers(spec)
    engine = CompiledBackend(build, env, n_layers=n_layers)
    bengine = BatchedBackend(engine, device=DEV)
    n_cfgs = len(list(dse.enumerate_configs(world, **enum)))
    kw = dict(n_layers=n_layers, name=spec.name, backend="batched", **enum)

    # ---- the main path, with every launch count at 0 just before ----
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with spans.profiled() as prof:
        t0 = time.perf_counter()
        start.record()
        res = dse.sweep(build, env, world, H100_HGX, engine=bengine, **kw)
        end.record()
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    counts = {k: module.launches for k, module in COUNTERS.items()}
    sweep_events_s = start.elapsed_time(end) / 1e3
    # ---- read just after ----
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    bstats, estats = res.batch_stats, res.engine_stats
    calls = len(bstats["batch_sizes"])
    prefiltered = sum(1 for s in res.skipped if s.prefiltered)
    require(len(res) > 0, "the sweep found no feasible point")
    require(bstats["points"] == len(res),
            f"{len(res) - bstats['points']} of {len(res)} points went to the "
            f"compiled path")
    require(counts["cost_reduce"] == calls,
            f"cost_reduce launched {counts['cost_reduce']} times for {calls} "
            f"class calls (want 1 each)")
    require(all(n == 0 for k, n in counts.items() if k != "cost_reduce"),
            f"the sweep launched a model's kernel: {counts}")
    for p in res:
        require(all(np.isfinite([p.sim.step_time, p.sim.comm_time,
                                 p.mem.peak_bytes]))
                and p.sim.step_time > 0, f"{p.label}: not a finite step")
    entry = next(k for k in kernels if k["name"] == "cost_reduce")
    entry["launches"] = counts["cost_reduce"]
    totals = prof.totals()

    # every point against the compiled backend (rel 1e-6)
    t0 = time.perf_counter()
    compiled = {p.label: dse.evaluate_point_compiled(engine, p.cfg, H100_HGX,
                                                     reuse=True)
                for p in res}
    compiled_s = time.perf_counter() - t0
    worst_compiled = _worst(res, compiled)
    require(worst_compiled <= SWEEP_REL,
            f"batched vs compiled: {worst_compiled:.3e} > {SWEEP_REL}")

    # the same sweep on the CPU, matched by label (ties may reorder)
    t0 = time.perf_counter()
    cpu = dse.sweep(build, env, world, H100_HGX,
                    engine=BatchedBackend(engine, device="cpu"), **kw)
    cpu_s = time.perf_counter() - t0
    require(sorted(p.label for p in cpu) == sorted(p.label for p in res)
            and len(cpu.skipped) == len(res.skipped),
            "the card's and the CPU's sweeps differ in points or skips")
    worst_cpu = _worst(res, {p.label: p for p in cpu})
    require(worst_cpu <= CARD_VS_CPU_REL,
            f"card vs cpu: {worst_cpu:.3e} > {CARD_VS_CPU_REL}")

    # a warm evaluation of the same points, every class kernel built
    feasible = [p.cfg for p in res]
    torch.cuda.synchronize()
    with spans.profiled() as warm_prof:
        t0 = time.perf_counter()
        start.record()
        bengine.evaluate_many(feasible, H100_HGX)
        end.record()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    warm_events_s = start.elapsed_time(end) / 1e3
    extra = {}
    if with_profile:
        extra["profile"] = profile_sweep(bengine, feasible, H100_HGX)

    def span_s(name):
        return totals.get(name, {}).get("total_s", 0.0)
    best = res[0]
    return {
        **extra,
        "model": spec.name, "layers": spec.n_layers, "mode": "train",
        "batch": SWEEP["batch"], "seq": SWEEP["seq"], "world": world,
        "hw": H100_HGX.name, "enumerate": {k: list(v) if isinstance(v, tuple)
                                           else v for k, v in enum.items()},
        "configs": n_cfgs, "feasible_configs": n_cfgs - prefiltered,
        "points": len(res), "batched_points": bstats["points"],
        "skipped": len(res.skipped), "prefiltered": prefiltered,
        "structure_classes": estats["classes"],
        "class_kernels": bstats["kernels"], "class_calls": calls,
        "batch_sizes": {"mean": bstats["points"] / calls,
                        "max": max(bstats["batch_sizes"])},
        "cost_reduce_launches": counts["cost_reduce"],
        "assemble_s": assemble_s, "sweep_s": sweep_s,
        "sweep_s_cuda_events": sweep_events_s,
        "lowering_s": span_s("compiled.lower"),
        "class_kernel_build_s": span_s("batched.kernel_build"),
        "evaluate_many_s": span_s("batched.evaluate_many"),
        "points_per_s": len(res) / sweep_s,
        "warm_evaluate_s": warm_s, "warm_evaluate_s_cuda_events":
        warm_events_s, "warm_points_per_s": len(res) / warm_s,
        "per_class_call_warm": _class_call_split(warm_prof, calls),
        "peak_memory_gb": peak_gb,
        "vs_compiled_worst_share_of_rel": worst_compiled / SWEEP_REL,
        "compiled_check_s": compiled_s,
        "card_vs_cpu_worst": worst_cpu, "card_vs_cpu_rel": CARD_VS_CPU_REL,
        "cpu_sweep_s": cpu_s,
        "best": {"label": best.label, "step_ms": best.step_ms,
                 "peak_gb": best.peak_gb},
    }


# ---------------------------------------------------------------------------
# api: STAGE's front door, through the batched backend on the card
# ---------------------------------------------------------------------------

# the sweep phase's model and training step, a narrower enumeration (pp <= 2,
# 8 microbatches) ranked by goodput under failures (a chip MTBF of 1000
# hours); a serving job of 8-request 2048-token prompts and 128 decode steps
# over every power-of-two prefill/decode split of 8 devices; the paper's
# scale (Fig 13: 32 768 GPUs)
API = dict(arch="qwen3-14b", batch=256, seq=4096, world=64, mtbf=3.6e6,
           enum=dict(max_pp=2, microbatches=(8,)),
           serve=dict(batch=8, seq=2048, decode_steps=128, world=8),
           paper=dict(batch=4096, seq=4096, dp=512, tp=8, pp=8))


def _serving_worst(rows, reference) -> float:
    """Largest relative error of a serving sweep's rows against
    ``reference``'s, row by row, after requiring the same rows in the same
    order: the prefill step time, TTFT and tokens/s."""
    def key(p):
        return p.split, p.prefill_cfg.describe(), p.decode_cfg.describe()
    require(len(rows) > 0 and [key(p) for p in rows]
            == [key(q) for q in reference],
            "the serving sweeps differ in rows or their order")

    def values(p):
        pre = next(ph for ph in p.result.phases if ph.mode == "prefill")
        return pre.step_last, p.result.ttft, p.tokens_per_s
    return max(abs(a - b) / abs(b) for p, q in zip(rows, reference)
               for a, b in zip(values(p), values(q)))


def _dir_bytes(path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(Path(path).iterdir())}


def phase_api(kernels: list) -> dict:
    import contextlib
    import io
    import tempfile
    from repro_torch import H100_HGX, Job, Scenario
    from repro_torch.api import _batched_engines
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.obs import spans
    from repro_torch.obs.timeline import validate_chrome_trace
    spec = get_arch(API["arch"]).spec
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == SERVED[API["arch"]]["widths"], "not the published qwen3-14b")
    world, enum = API["world"], API["enum"]
    base = Scenario(spec).train(batch=API["batch"], seq=API["seq"]) \
        .resilience(mtbf=API["mtbf"])
    sc = base.with_backend("batched")
    kw = dict(rank_by="effective_goodput", **enum)
    seconds = {}

    # ---- 1. the train sweep through the front door: the main path, with
    # every launch count at 0 just before and read just after ----
    reset_counts()
    torch.cuda.synchronize()
    with spans.profiled() as prof:
        t0 = time.perf_counter()
        res = sc.sweep(world, H100_HGX, device="cuda", **kw)
        torch.cuda.synchronize()
        seconds["sweep"] = time.perf_counter() - t0
    counts = {k: module.launches for k, module in COUNTERS.items()}
    bstats = res.batch_stats
    calls = len(bstats["batch_sizes"])
    require(len(res) > 0, "the front-door sweep found no feasible point")
    require(res.backend == "batched" and bstats["points"] == len(res),
            f"{len(res) - bstats['points']} of {len(res)} points went to "
            f"the compiled path")
    require(counts["cost_reduce"] == calls,
            f"cost_reduce launched {counts['cost_reduce']} times for {calls} "
            f"class calls (want 1 each)")
    require(all(n == 0 for k, n in counts.items() if k != "cost_reduce"),
            f"the sweep launched a model's kernel: {counts}")
    require(all(p.resilience is not None for p in res),
            "a point was not scored for resilience")
    effs = [p.effective_step_time for p in res]
    require(effs == sorted(effs), "not ranked by effective goodput")
    for p in res:
        require(np.isfinite([p.sim.step_time, p.effective_step_time,
                             p.mem.peak_bytes]).all()
                and 0 < p.resilience.goodput <= 1,
                f"{p.label}: not a finite step or goodput")

    # the same scenario on the compiled backend, on the host (rel 1e-6 by
    # label, the same ranking), and on the batched backend on the CPU
    t0 = time.perf_counter()
    comp = base.sweep(world, H100_HGX, **kw)
    seconds["compiled_check"] = time.perf_counter() - t0
    compiled = {p.label: p for p in comp}
    require(sorted(compiled) == sorted(p.label for p in res)
            and len(comp.skipped) == len(res.skipped),
            "the batched and compiled sweeps differ in points or skips")
    worst_compiled = max(
        _worst(res, compiled),
        max(abs(p.effective_step_time - compiled[p.label].effective_step_time)
            / compiled[p.label].effective_step_time for p in res))
    require(worst_compiled <= SWEEP_REL,
            f"front door, batched vs compiled: {worst_compiled:.3e} > "
            f"{SWEEP_REL}")
    require([p.label for p in res] == [p.label for p in comp],
            "the batched sweep ranks otherwise than the compiled one")
    t0 = time.perf_counter()
    cpu = sc.sweep(world, H100_HGX, device="cpu", **kw)
    seconds["cpu_check"] = time.perf_counter() - t0
    on_cpu = {p.label: p for p in cpu}
    require(sorted(on_cpu) == sorted(compiled),
            "the card's and the CPU's front-door sweeps differ in points")
    worst_cpu = max(
        _worst(res, on_cpu),
        max(abs(p.effective_step_time - on_cpu[p.label].effective_step_time)
            / on_cpu[p.label].effective_step_time for p in res))
    require(worst_cpu <= CARD_VS_CPU_REL,
            f"front door, card vs cpu: {worst_cpu:.3e} > {CARD_VS_CPU_REL}")

    # ---- 2. a serving sweep, the prefill pool on the card: a main path of
    # its own, every launch count at 0 just before and read just after ----
    srv = API["serve"]

    def job(backend):
        return Job.request(prefill=Scenario(spec).prefill(
            batch=srv["batch"], seq=srv["seq"]).with_backend(backend),
            decode_steps=srv["decode_steps"])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = job("batched").sweep(srv["world"], H100_HGX, splits="auto",
                                device="cuda")
    torch.cuda.synchronize()
    seconds["serving_sweep"] = time.perf_counter() - t0
    serve_counts = {k: module.launches for k, module in COUNTERS.items()}
    pre_env = Scenario(spec).prefill(batch=srv["batch"], seq=srv["seq"]).env()
    serve_calls = len(_batched_engines.engine(spec, "prefill", pre_env,
                                              DEV).batch_sizes)
    require(serve_counts["cost_reduce"] == serve_calls > 0,
            f"serving sweep: {serve_counts['cost_reduce']} cost_reduce "
            f"launches for {serve_calls} class calls (want 1 each)")
    require(all(n == 0 for k, n in serve_counts.items() if k != "cost_reduce"),
            f"the serving sweep launched a model's kernel: {serve_counts}")
    # the same rows on the compiled backend (rel 1e-6) and on the batched
    # backend on the CPU, through the plain cost_reduce (rel 1e-10)
    t0 = time.perf_counter()
    rows_compiled = job("compiled").sweep(srv["world"], H100_HGX,
                                          splits="auto")
    seconds["serving_compiled_check"] = time.perf_counter() - t0
    serve_worst = _serving_worst(rows, rows_compiled)
    require(serve_worst <= SWEEP_REL,
            f"serving sweep vs compiled: {serve_worst:.3e} > {SWEEP_REL}")
    t0 = time.perf_counter()
    rows_cpu = job("batched").sweep(srv["world"], H100_HGX, splits="auto",
                                    device="cpu")
    seconds["serving_cpu_check"] = time.perf_counter() - t0
    serve_worst_cpu = _serving_worst(rows, rows_cpu)
    require(serve_worst_cpu <= CARD_VS_CPU_REL,
            f"serving sweep, card vs cpu: {serve_worst_cpu:.3e} > "
            f"{CARD_VS_CPU_REL}")
    # a row's numbers come from one evaluation of the job it chose; the
    # card's numbers behind each choice are its prefill pool's sweep, held
    # here point by point against the CPU's and the compiled backend's
    pre = Scenario(spec).prefill(batch=srv["batch"], seq=srv["seq"])
    pool_worst = {"cpu": 0.0, "compiled": 0.0}
    t0 = time.perf_counter()
    for wp, _ in dse.enumerate_pool_splits(srv["world"]):
        card = pre.with_backend("batched").sweep(wp, H100_HGX, device="cuda")
        refs = {"cpu": pre.with_backend("batched").sweep(wp, H100_HGX,
                                                         device="cpu"),
                "compiled": pre.sweep(wp, H100_HGX)}
        for name, ref in refs.items():
            by_label = {p.label: p for p in ref}
            require(sorted(by_label) == sorted(p.label for p in card),
                    f"prefill pool of {wp}: the card's and the {name} "
                    f"sweep differ in points")
            pool_worst[name] = max(pool_worst[name], _worst(card, by_label))
    seconds["serving_pool_checks"] = time.perf_counter() - t0
    require(pool_worst["cpu"] <= CARD_VS_CPU_REL
            and pool_worst["compiled"] <= SWEEP_REL,
            f"prefill pool sweeps: {pool_worst}")

    # ---- 3. Chakra export of the best point, and its timeline ----
    best = res[0]
    tr = base.with_cfg(best.cfg).trace()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n_files = tr.export_chakra(str(Path(tmp) / "a"))
        seconds["chakra_export"] = time.perf_counter() - t0
        tr.export_chakra(str(Path(tmp) / "b"))
        first, second = _dir_bytes(Path(tmp) / "a"), _dir_bytes(Path(tmp) / "b")
        require(n_files == world and len(first) == world + 1,
                f"{n_files} rank files for {world} ranks")
        require(first == second, "a second Chakra export is not byte-equal")
        export_bytes = sum(len(b) for b in first.values())
        t0 = time.perf_counter()
        tl = tr.timeline(str(Path(tmp) / "timeline.json"), H100_HGX)
        seconds["timeline"] = time.perf_counter() - t0
        obj = json.loads((Path(tmp) / "timeline.json").read_text())
        problems = validate_chrome_trace(obj)
        require(problems == [], f"timeline schema: {problems[:3]}")
        require(tl.reconcile(tr.simulate(H100_HGX).step_time) == [],
                "the timeline does not reconcile with the step time")
        timeline_events = len(obj["traceEvents"])

    # ---- 4. the paper's scale ----
    pap = API["paper"]
    t0 = time.perf_counter()
    big = Scenario(spec).train(batch=pap["batch"], seq=pap["seq"]).parallel(
        dp=pap["dp"], tp=pap["tp"], pp=pap["pp"]).trace()
    stage0 = big.chakra_stage(0)
    seconds["paper_scale_stage"] = time.perf_counter() - t0
    nodes = stage0["nodes"]
    comm = [nd for nd in nodes if nd["type"].startswith("COMM")]
    require(big.scenario.world == 32768 and len(nodes) > 0 and comm,
            "the 32 768-GPU stage has no nodes or no communication")

    # ---- 5. the serve launcher's pre-flight line ----
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launcher.announce_preflight(spec, slots=4, kv_len=128,
                                          device=DEV)
    line = out.getvalue().strip()
    require(line.startswith("[serve] STAGE pre-flight: "),
            f"no pre-flight line: {line!r}")
    print(line, flush=True)

    def span_s(name):
        return prof.totals().get(name, {}).get("total_s", 0.0)
    by_step = min(res, key=lambda p: p.sim.step_time)
    return {
        "model": spec.name, "layers": spec.n_layers, "batch": API["batch"],
        "seq": API["seq"], "world": world, "hw": H100_HGX.name,
        "mtbf_s": API["mtbf"], "enumerate": {k: list(v) if isinstance(
            v, tuple) else v for k, v in enum.items()},
        "points": len(res), "skipped": len(res.skipped),
        "structure_classes": res.engine_stats["classes"],
        "class_kernels": bstats["kernels"], "class_calls": calls,
        "cost_reduce_launches": counts["cost_reduce"],
        "seconds": seconds,
        "lowering_s": span_s("compiled.lower"),
        "class_kernel_build_s": span_s("batched.kernel_build"),
        "best_by_step_time": {"label": by_step.label,
                              "step_ms": by_step.step_ms},
        "best_by_effective_goodput": {
            "label": best.label, "step_ms": best.step_ms,
            "effective_step_ms": best.effective_step_time * 1e3,
            "goodput": best.resilience.goodput,
            "recovery": best.resilience.recovery},
        "vs_compiled_worst": worst_compiled, "vs_compiled_rel": SWEEP_REL,
        "card_vs_cpu_worst": worst_cpu, "card_vs_cpu_rel": CARD_VS_CPU_REL,
        "serving": {"world": srv["world"], "rows": len(rows),
                    "launches": serve_counts, "class_calls": serve_calls,
                    "vs_compiled_worst": serve_worst,
                    "card_vs_cpu_worst": serve_worst_cpu,
                    "prefill_pools_worst": pool_worst,
                    "top": rows[0].row()},
        "chakra": {"label": best.label, "files": n_files,
                   "bytes": export_bytes, "reexport_byte_equal": True,
                   "timeline_events": timeline_events},
        "paper_scale": {"gpus": big.scenario.world, "stage": 0,
                        "nodes": len(nodes), "comm_nodes": len(comm)},
        "preflight": line,
    }


# ---------------------------------------------------------------------------
# analysis: STAGE's verifier and prover on the card's sweeps
# ---------------------------------------------------------------------------

# the sweep phase's space (so its cost_reduce shapes are rows of the kernels
# phase), proved and verified; then a demanding arch the port names since
# the analysis slice: deepseek-v2-236b (MoE + MLA; arXiv:2405.04434) at its
# published widths, 8 microbatches, pp <= 8
ANALYSIS = dict(arch="qwen3-14b", batch=256, seq=4096, world=64,
                enum=SWEEP["enum"],
                demanding=dict(arch="deepseek-v2-236b",
                               widths=(60, 5120, 12288, 102400),
                               enum=dict(microbatches=(8,), max_pp=8)))


def _same_ranking(points, reference, rel: float) -> float:
    """The largest error of ``points`` against ``reference`` (by label, as
    ``_worst``), after requiring the same labels and the same order up to
    ties: at each rank the two step times agree within ``rel``."""
    by_label = {p.label: p for p in reference}
    require(len(points) == len(reference) > 0
            and sorted(by_label) == sorted(p.label for p in points),
            "the two sweeps differ in points")
    for p, q in zip(points, reference):
        require(p.label == q.label or abs(p.sim.step_time - q.sim.step_time)
                <= rel * q.sim.step_time,
                f"the two sweeps rank otherwise: {p.label} / {q.label}")
    return _worst(points, by_label)


def _timed(module, name: str, seconds: dict, key: str):
    """Replace ``module.name`` by a wrapper that adds its host seconds to
    ``seconds[key]``; returns the original."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return out
    setattr(module, name, wrapper)
    return fn


def _drop_recv(src: Path, dst: Path) -> tuple:
    """Copy the rank files of ``src`` to ``dst`` with the first
    COMM_RECV_NODE of the first rank file that has one deleted."""
    dst.mkdir()
    victim = None
    for f in sorted(src.iterdir()):
        data = f.read_bytes()
        if victim is None and f.name.startswith("rank"):
            t = json.loads(data)
            recvs = [i for i, n in enumerate(t["nodes"])
                     if n["type"] == "COMM_RECV_NODE"]
            if recvs:
                victim = (f.name, t["nodes"][recvs[0]]["name"])
                del t["nodes"][recvs[0]]
                data = json.dumps(t).encode()
        (dst / f.name).write_bytes(data)
    require(victim is not None, f"no COMM_RECV_NODE in {src}")
    return victim


def _batched_stats(scenario) -> dict:
    """The process-wide batched engine of ``scenario`` on the card: its
    cumulative points and class calls (an earlier phase may have used it)."""
    from repro_torch.api import _batched_engines
    st = _batched_engines.engine(scenario.spec, scenario.mode, scenario.env(),
                                 DEV).stats()
    return {"points": st["points"], "calls": len(st["batch_sizes"])}


def phase_analysis(kernels: list) -> dict:
    import tempfile
    from repro_torch import H100_HGX, Job, Scenario
    from repro_torch.analysis import check_timeline_file, check_trace_dir
    from repro_torch.analysis import prover
    from repro_torch.obs import metrics
    spec = get_arch(ANALYSIS["arch"]).spec
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == SERVED[ANALYSIS["arch"]]["widths"],
            "not the published qwen3-14b")
    world, enum = ANALYSIS["world"], ANALYSIS["enum"]
    base = Scenario(spec).train(batch=ANALYSIS["batch"], seq=ANALYSIS["seq"])
    sc = base.with_backend("batched")
    seconds: dict = {}

    # ---- 1. the sweep, proved and verified on the card: the main path,
    # every launch count at 0 just before and read just after ----
    prove_space = _timed(prover, "prove_space", seconds, "prove")
    before = _batched_stats(sc)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sc.sweep(world, H100_HGX, prove=True, verify=True, device="cuda",
                   **enum)
    torch.cuda.synchronize()
    seconds["sweep_prove_verify"] = time.perf_counter() - t0
    prover.prove_space = prove_space
    counts = {k: module.launches for k, module in COUNTERS.items()}
    after = _batched_stats(sc)
    calls = after["calls"] - before["calls"]
    cert = res.certificates
    require(cert is not None and cert.ok
            and "all invariants certified" in cert.summary(),
            f"the space did not certify: {cert and cert.report.render()}")
    require(res.backend == "batched"
            and after["points"] - before["points"] == len(res),
            "a point went to the compiled path")
    require(counts["cost_reduce"] == calls > 0,
            f"cost_reduce launched {counts['cost_reduce']} times for {calls} "
            f"class calls (want 1 each)")
    require(all(n == 0 for k, n in counts.items() if k != "cost_reduce"),
            f"the sweep launched a model's kernel: {counts}")
    require(res.skipped and all(
        len(sk.diagnostics) == 1 and sk.diagnostics[0].code == "STG007"
        for sk in res.skipped),
        "a skipped config does not carry exactly one STG007 diagnostic")
    entry = next(k for k in kernels if k["name"] == "cost_reduce")
    if entry["launches"] == 0:                # the sweep phase did not run
        entry["launches"] = counts["cost_reduce"]

    # the same points without prove / verify on the card, and on the CPU
    t0 = time.perf_counter()
    plain = sc.sweep(world, H100_HGX, device="cuda", **enum)
    seconds["card_check"] = time.perf_counter() - t0
    worst_card = _same_ranking(res, plain, CARD_VS_CPU_REL)
    t0 = time.perf_counter()
    cpu = sc.sweep(world, H100_HGX, device="cpu", **enum)
    seconds["cpu_check"] = time.perf_counter() - t0
    worst_cpu = _same_ranking(res, cpu, CARD_VS_CPU_REL)
    require(worst_card <= CARD_VS_CPU_REL and worst_cpu <= CARD_VS_CPU_REL,
            f"proved sweep vs unproved {worst_card:.3e}, vs cpu "
            f"{worst_cpu:.3e} > {CARD_VS_CPU_REL}")

    # ---- 2. branch and bound with and without the certificates ----
    pruned = metrics.counter("dse.bnb_cert_pruned")
    t0 = time.perf_counter()
    bnb = sc.sweep(world, H100_HGX, search="bnb", device="cuda", **enum)
    before = pruned.value
    bnb_proved = sc.sweep(world, H100_HGX, search="bnb", prove=True,
                          device="cuda", **enum)
    cert_pruned = pruned.value - before
    seconds["bnb"] = time.perf_counter() - t0
    require(bnb_proved.certificates.ok and bnb_proved.visited == bnb.visited
            and [p.label for p in bnb_proved] == [p.label for p in bnb]
            and [p.sim.step_time for p in bnb_proved]
            == [p.sim.step_time for p in bnb],
            "bnb with certificates: another front or another visit count")
    require(cert_pruned > 0, "no candidate was pruned by a certificate")

    # ---- 3. the verifier on files the card's best points produced ----
    t0 = time.perf_counter()
    best = res[0]
    tr = base.with_cfg(best.cfg).trace()
    rep = tr.verify(include_graph=True, chakra=True)
    require(rep.ok and not rep.diagnostics, rep.render())
    piped = next(p for p in res if p.cfg.pp > 1)
    job = Job.request(prefill=Scenario(spec).prefill(
        batch=API["serve"]["batch"], seq=API["serve"]["seq"]),
        decode_steps=API["serve"]["decode_steps"])
    job_rep = job.verify(deep=True)
    require(job_rep.ok and not job_rep.diagnostics, job_rep.render())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        n_files = tr.export_chakra(str(tmp / "best"))
        dir_rep = check_trace_dir(str(tmp / "best"))
        require(n_files == world and dir_rep.ok and not dir_rep.diagnostics,
                dir_rep.render())
        tr.timeline(str(tmp / "timeline.json"), H100_HGX)
        tl_rep = check_timeline_file(str(tmp / "timeline.json"))
        require(tl_rep.ok and not tl_rep.diagnostics, tl_rep.render())
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", str(tmp / "best"),
             "--sarif", str(tmp / "out.sarif")],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=300)
        require(cli.returncode == 0, f"python -m repro_torch.analysis exited "
                f"{cli.returncode}: {cli.stdout[-500:]} {cli.stderr[-500:]}")
        sarif = json.loads((tmp / "out.sarif").read_text())
        run = sarif["runs"][0]
        require(run["tool"]["driver"]["name"] == "repro_torch.analysis"
                and not [r for r in run["results"] if r["level"] == "error"],
                "the SARIF log holds error-level results")
        # a seeded fault in the files of a pipelined point
        base.with_cfg(piped.cfg).trace().export_chakra(str(tmp / "piped"))
        clean = check_trace_dir(str(tmp / "piped"))
        require(clean.ok and not clean.diagnostics, clean.render())
        victim = _drop_recv(tmp / "piped", tmp / "fault")
        fault = check_trace_dir(str(tmp / "fault"))
        require("STG101" in fault.codes() and not fault.ok,
                f"a dropped recv ({victim}) was not reported: "
                f"{fault.render()}")
    seconds["verify"] = time.perf_counter() - t0

    # ---- 4. deepseek-v2-236b at published widths, verified on the card:
    # a main path of its own ----
    dem = ANALYSIS["demanding"]
    dspec = get_arch(dem["arch"]).spec
    require((dspec.n_layers, dspec.d_model, dspec.d_ff, dspec.vocab)
            == dem["widths"] and dspec.mla is not None
            and dspec.moe is not None, "not the published deepseek-v2-236b")
    dbase = Scenario(dspec).train(batch=ANALYSIS["batch"],
                                  seq=ANALYSIS["seq"])
    dsc = dbase.with_backend("batched")
    before = _batched_stats(dsc)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dres = dsc.sweep(world, H100_HGX, verify=True, device="cuda",
                     **dem["enum"])
    torch.cuda.synchronize()
    seconds["deepseek_sweep"] = time.perf_counter() - t0
    dcounts = {k: module.launches for k, module in COUNTERS.items()}
    after = _batched_stats(dsc)
    dcalls = after["calls"] - before["calls"]
    require(after["points"] - before["points"] == len(dres) > 0,
            "deepseek-v2: a point went to the compiled path")
    require(dcounts["cost_reduce"] == dcalls > 0
            and all(n == 0 for k, n in dcounts.items() if k != "cost_reduce"),
            f"deepseek-v2: launches {dcounts} for {dcalls} class calls")
    require(all(len(sk.diagnostics) == 1
                and sk.diagnostics[0].code == "STG007"
                for sk in dres.skipped),
            "deepseek-v2: a skipped config without its STG007 diagnostic")
    t0 = time.perf_counter()
    dcpu = dsc.sweep(world, H100_HGX, device="cpu", **dem["enum"])
    seconds["deepseek_cpu_check"] = time.perf_counter() - t0
    dworst_cpu = _same_ranking(dres, dcpu, CARD_VS_CPU_REL)
    t0 = time.perf_counter()
    dcomp = dbase.sweep(world, H100_HGX, **dem["enum"])
    seconds["deepseek_compiled_check"] = time.perf_counter() - t0
    dworst_comp = _same_ranking(dres, dcomp, SWEEP_REL)
    require(dworst_cpu <= CARD_VS_CPU_REL and dworst_comp <= SWEEP_REL,
            f"deepseek-v2: card vs cpu {dworst_cpu:.3e}, vs compiled "
            f"{dworst_comp:.3e}")
    for p in dres:
        require(np.isfinite([p.sim.step_time, p.mem.peak_bytes]).all()
                and p.sim.step_time > 0, f"{p.label}: not a finite step")

    return {
        "model": spec.name, "layers": spec.n_layers,
        "batch": ANALYSIS["batch"],
        "seq": ANALYSIS["seq"], "world": world, "hw": H100_HGX.name,
        "enumerate": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in enum.items()},
        "seconds": seconds,
        "points": len(res), "skipped": len(res.skipped),
        "skipped_with_stg007": len(res.skipped),
        "structure_classes": res.engine_stats["classes"],
        "class_calls": calls, "launches": counts,
        "certificate": cert.summary(),
        "certified_classes": len(cert.classes),
        "lattice_points": cert.lattice_points,
        "vs_unproved_card_worst": worst_card, "card_vs_cpu_worst": worst_cpu,
        "card_vs_cpu_rel": CARD_VS_CPU_REL,
        "bnb": {"points": len(bnb), "visited": bnb.visited,
                "total": bnb.total, "cert_pruned": cert_pruned},
        "verify": {"best": best.label, "trace_checked": dict(rep.checked),
                   "job": job.describe(), "job_checked": dict(job_rep.checked),
                   "chakra_files": n_files, "sarif_results":
                   len(run["results"]), "seeded_fault": {
                       "point": piped.label, "dropped_recv": list(victim),
                       "codes": sorted(fault.codes())}},
        "deepseek_v2": {
            "model": dspec.name, "layers": dspec.n_layers,
            "enumerate": {k: list(v) if isinstance(v, tuple) else v
                          for k, v in dem["enum"].items()},
            "points": len(dres), "skipped": len(dres.skipped),
            "structure_classes": dres.engine_stats["classes"],
            "class_calls": dcalls, "launches": dcounts,
            "card_vs_cpu_worst": dworst_cpu,
            "vs_compiled_worst": dworst_comp, "vs_compiled_rel": SWEEP_REL,
            "best": {"label": dres[0].label, "step_ms": dres[0].step_ms}},
    }


# ---------------------------------------------------------------------------
# parity: the kernel inside the model against the naive core
# ---------------------------------------------------------------------------

# logits of the smoke specs, card against its reference path: fp32 sums
# differ only in their order; in float16 each side rounds every layer's
# activations to float16 (about 1e-3 relative) on its own path, so the
# logits (|x| ~5, an ulp 0.004) differ by a few float16 ulps (0.006 in a CPU
# rehearsal of the qwen3 pair), and 5e-2 is ~13 ulps
PARITY_TOL = {"float32": 1e-4, "float16": 5e-2}


# the smoke specs whose attention the parity phase holds against the naive
# core: qwen3, granite's MQA, minitron's gelu FFN, gemma2's windows and
# softcaps, deepseek-moe's MoE, deepseek-v2's MLA with q/k of 24 and v of 16
# through the fma and fp32 decode kernels, jamba's Mamba + MoE hybrid,
# whisper's encoder and cross-attention (frames of 30), internvl2's vision
# prefix (8 positions)
PARITY_SPECS = ("qwen3-14b", "granite-34b", "minitron-8b", "gemma2-27b",
                "deepseek-moe-16b", "deepseek-v2-236b", "jamba-v0.1-52b",
                "whisper-medium", "internvl2-26b")


def phase_parity(dtype: str = "float32", name: str = "qwen3-14b") -> dict:
    """The smoke spec of ``name`` at ``dtype``: attention through the kernel
    (``"cuda"``; a float16 runtime hands it fp32 q/k/v) against the naive
    core: every engine step's logits within ``PARITY_TOL``, the same greedy
    tokens, prefill logits within ``PARITY_TOL``.

    Two paths whose logits may differ by the tolerance may pick different
    tokens where a step's two best logits are closer than it (a tie): the
    engines are compared step by step up to the first step whose greedy
    picks differ, and there every differing pick must be such a tie on the
    naive core's logits; the two runs diverge after it, so their tokens are
    compared only where no step ties."""
    spec = get_arch(name).smoke
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    rt_cuda = RuntimeCfg(attention_impl="cuda", **kw)
    rt_naive = RuntimeCfg(attention_impl="naive", **kw)
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(spec, rt_cuda, gen, device=DEV)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, spec.vocab, size=rng.randint(3, 9))
               for _ in range(3)]

    def serve(rt):
        """-> (greedy tokens by request, every step's (tokens, logits))."""
        eng = Engine(spec, rt, params, batch_slots=2, kv_len=64, device=DEV)
        steps, step = [], eng.step_fn

        def recorded(p, cache, tok):
            logits, cache = step(p, cache, tok)
            steps.append((tok.clone(), logits[:, 0].float().clone()))
            return logits, cache

        eng.step_fn = recorded
        for rid, pr in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=pr, max_new=6))
        return {r.rid: r.out for r in eng.run(max_steps=64)}, steps

    reset_counts()
    got, got_steps = serve(rt_cuda)
    kernel_launches = fa.launches
    reset_counts()
    want, want_steps = serve(rt_naive)
    require(fa.launches == 0, "the naive core launched the kernel")
    require(kernel_launches > 0, "the cuda path did not run the kernel")
    require(sorted(got) == [0, 1, 2] == sorted(want)
            and all(len(o) == 6 for o in (*got.values(), *want.values())),
            f"not every request served ({dtype}): cuda {got}, naive {want}")
    step_err, tie = 0.0, None
    for i, ((tok_c, l_c), (tok_n, l_n)) in enumerate(zip(got_steps,
                                                         want_steps)):
        require(torch.equal(tok_c, tok_n), "the engines fed other tokens "
                "before their picks differed")
        step_err = max(step_err, (l_c - l_n).abs().max().item())
        require(step_err <= PARITY_TOL[dtype],
                f"step {i} logits ({dtype}): cuda vs naive max abs err "
                f"{step_err}")
        pick_c, pick_n = l_c.argmax(-1), l_n.argmax(-1)
        if not torch.equal(pick_c, pick_n):
            rows = (pick_c != pick_n).nonzero().flatten()
            gaps = (l_n[rows, pick_n[rows]] - l_n[rows, pick_c[rows]])
            require(bool((gaps <= PARITY_TOL[dtype]).all()),
                    f"step {i}: greedy picks differ ({dtype}) where the "
                    f"naive logits are {gaps.tolist()} apart")
            tie = {"step": i, "rows": rows.tolist(), "gaps": gaps.tolist()}
            break
    if tie is None:
        require(got == want,
                f"greedy tokens differ ({dtype}): cuda {got}, naive {want}")
    tokens = torch.from_numpy(rng.randint(0, spec.vocab, size=(2, 40))).to(DEV)
    prefix = {key: torch.from_numpy(rng.standard_normal(
        (2, n, spec.d_model)).astype(np.float32)).to(DEV)
        for key, n in (("frames", spec.encoder_layers and spec.enc_seq),
                       ("vision", spec.vision_seq)) if n}
    reset_counts()
    l_cuda = lm.forward(params, tokens, spec, rt_cuda, **prefix)
    prefill_launches = fa.launches
    l_naive = lm.forward(params, tokens, spec, rt_naive, **prefix)
    require(prefill_launches == flash_launches(spec)[1],
            f"the prefill launched the kernel {prefill_launches} times")
    require(l_cuda.shape == (2, spec.vision_seq + 40, spec.vocab),
            f"smoke logits of shape {tuple(l_cuda.shape)}")
    torch.cuda.synchronize()
    # a final softcap (gemma2) returns fp32 logits, as in the JAX package
    want_dtype = torch.float32 if spec.final_softcap else getattr(torch, dtype)
    require(l_cuda.dtype == want_dtype,
            f"smoke logits in {l_cuda.dtype}, not {want_dtype}")
    require(torch.isfinite(l_cuda).all(), "smoke logits not finite")
    err = (l_cuda.float() - l_naive.float()).abs().max().item()
    require(err <= PARITY_TOL[dtype],
            f"smoke logits ({dtype}): cuda vs naive max abs err {err}")
    return {"spec": spec.name, "dtype": dtype, "requests": 3,
            "tokens_equal": got == want, "tie": tie,
            "engine_steps": len(got_steps),
            "step_logits_max_abs_err": step_err,
            "engine_flash_launches": kernel_launches,
            "prefill_flash_launches": prefill_launches,
            "logits_max_abs": l_naive.float().abs().max().item(),
            "logits_max_abs_err": err, "tolerance": PARITY_TOL[dtype]}


def phase_parity_rwkv(dtype: str = "float32") -> dict:
    """The rwkv6 smoke spec at ``dtype``: the same parameters through the
    wkv6 kernel on the card and through its plain version on the CPU.
    Prefill of 40 tokens (one chunk of 40) and of 64 (two chunks of 32),
    and an engine whose decode steps run the kernel with C = 1."""
    spec = get_arch("rwkv6-7b").smoke
    rt = RuntimeCfg(param_dtype=dtype, compute_dtype=dtype)
    gen = torch.Generator(device=DEV).manual_seed(2)
    params = init_params(spec, rt, gen, device=DEV)
    cpu_params = lm._tree_map(lambda t: t.cpu(), params)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, spec.vocab, size=rng.randint(3, 9))
               for _ in range(3)]

    def serve(p, device):
        eng = Engine(spec, rt, p, batch_slots=2, kv_len=64, device=device)
        for rid, pr in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=pr, max_new=6))
        return {r.rid: r.out for r in eng.run(max_steps=64)}

    reset_counts()
    got = serve(params, DEV)
    engine_launches = wkv.launches
    want = serve(cpu_params, "cpu")
    require(engine_launches > 0, "the card's engine did not run the kernel")
    require(sorted(got) == [0, 1, 2] and got == want,
            f"greedy tokens differ ({dtype}): card {got}, cpu {want}")
    errs = {}
    for length in (40, 64):
        tokens = torch.from_numpy(rng.randint(0, spec.vocab, size=(2, length)))
        l_card = lm.forward(params, tokens.to(DEV), spec, rt)
        l_cpu = lm.forward(cpu_params, tokens, spec, rt)
        require(l_card.dtype == getattr(torch, dtype),
                f"smoke logits in {l_card.dtype}, not {dtype}")
        require(torch.isfinite(l_card).all(), "smoke logits not finite")
        errs[length] = (l_card.cpu().float()
                        - l_cpu.float()).abs().max().item()
        require(errs[length] <= PARITY_TOL[dtype],
                f"rwkv6 smoke logits ({dtype}, {length} tokens): card vs "
                f"cpu max abs err {errs[length]}")
    return {"spec": spec.name, "dtype": dtype, "requests": 3,
            "tokens_equal": True, "engine_wkv6_launches": engine_launches,
            "logits_max_abs_err": {f"S={k}": v for k, v in errs.items()},
            "tolerance": PARITY_TOL[dtype]}


# ---------------------------------------------------------------------------
# train: steps of two models at published width, the smoke specs' gradients
# on the card against the CPU, the kernels' refusal to be differentiated
# ---------------------------------------------------------------------------

# each trained model: its published (layers, d_model, d_ff, vocab) and the
# depth trained (reduced).  AdamW keeps the parameters (bf16), the new
# parameters, the gradients (bf16) and the old and new fp32 m and v alive at
# once (the update is functional): 22 bytes a parameter.  qwen3-14b's
# embedding and head are 1.556 B parameters and a layer 0.330 B, so 4
# layers are 2.88 B, 63 GB at the end of the update, and 40 would be 15 B;
# rwkv6-7b's 4 of 32 layers are 1.41 B.
TRAINED = {
    "qwen3-14b": dict(widths=(40, 5120, 17408, 151936), layers=4),
    "rwkv6-7b": dict(widths=(32, 4096, 14336, 65536), layers=4),
}
# bf16 parameters and compute, the reference's training attention (queries
# of a [2, 2048] batch in two blocks, keys in two chunks), the CE over
# chunks of 512, every layer under activation checkpointing
TRAIN_RT = dict(attention_impl="chunked", attn_chunk=1024, loss_chunk=512,
                remat="full")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6
# the overfit check of tests/test_train_integration.py: six steps on one
# batch take the loss down by at least 0.3.  lr 1e-4: at 1e-3 Adam
# overshoots at this width (qwen3-14b's loss 12.44 at the first step, 15.64
# at the sixth); at 1e-4 both models fall steadily
TRAIN_OPT = dict(lr=1e-4, warmup=2)
OVERFIT_DROP = 0.3
# leaves whose parameters are no matrix product: the embedding (a gather)
# and RWKV6's per-head bonus u (elementwise)
NOT_MATMUL = frozenset({"embed", "u"})


def train_flops(spec, params, tokens: int) -> dict:
    """Model FLOPs of one step, the numerator of ``mfu``: 6 x the parameters
    of matrix products x tokens (forward 2, backward 4), plus for each
    attention layer the two attention products QK^T and PV over every
    (query, key) pair of the sequence, forward and backward: 12 x heads x
    head dim x seq x tokens.  The chunked path computes the masked half of
    the causal square too, so it is counted.  The recomputation of
    activation checkpointing is not counted (it is not model work); nor is
    RWKV6's recurrence (under 0.4 % of its matrix products)."""
    matmul = sum(t.numel() for k, t in _named_leaves(params)
                 if t.dim() > 1 and k not in NOT_MATMUL)
    attn_layers = sum(lm._slot_kind(spec, l)["mixer"] == "attn"
                      for l in range(spec.n_layers))
    attention = 12 * attn_layers * spec.n_heads * spec.head_dim \
        * TRAIN_SEQ * tokens
    return {"matmul_params": matmul, "attention_layers": attn_layers,
            "flops_per_step": 6 * matmul * tokens + attention}


def phase_train(name: str) -> dict:
    """``TRAIN_STEPS`` steps of ``name`` at published width (bf16, cut in
    depth) on pipeline batch 0, repeated: the first a warm-up, the rest
    timed on the host's clock ending in a sync.  Losses and grad norms
    finite, the last loss ``OVERFIT_DROP`` below the first, and no kernel
    launched (training never reaches a forward-only kernel)."""
    trained = TRAINED[name]
    spec = get_arch(name).spec
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == trained["widths"], f"not the published {name}")
    published_layers = spec.n_layers
    spec = dataclasses.replace(spec, n_layers=trained["layers"])
    rt = RuntimeCfg(**TRAIN_RT)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(spec, rt, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    flops = train_flops(spec, params, TRAIN_BATCH * TRAIN_SEQ)
    pipe = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=spec.vocab, seed=0))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in pipe.batch(0).items()}
    step = make_train_step(spec, rt, OptCfg(**TRAIN_OPT))

    reset_counts()
    metrics = []
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)            # warm-up
    metrics.append(m)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        params, opt, m = step(params, opt, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
    counts = {k: module.launches for k, module in COUNTERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    lrs = [float(m["lr"]) for m in metrics]
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"{name}: losses {losses}, grad norms {norms}")
    require(losses[-1] < losses[0] - OVERFIT_DROP,
            f"{name}: the loss fell from {losses[0]} to {losses[-1]}, not "
            f"by {OVERFIT_DROP}")
    require(all(n == 0 for n in counts.values()),
            f"{name}: training launched a forward-only kernel: {counts}")
    require(int(opt["step"]) == TRAIN_STEPS, "the optimizer step count")
    require(all(t.dtype == torch.bfloat16 for t in leaves(params)),
            f"{name}: a parameter left bf16")
    del params, opt, batch, metrics, m
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {
        "model": spec.name, "layers": spec.n_layers,
        "published_layers": published_layers,
        "reduced": [f"depth {spec.n_layers} of {published_layers} layers"],
        "d_model": spec.d_model, "params": n_params, "dtype": "bfloat16",
        "runtime": TRAIN_RT, "opt": TRAIN_OPT,
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "init_s": init_s,
        "steps": TRAIN_STEPS, "first_step_ms": first_ms,
        "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
        "peak_memory_gb": peak_gb, **flops,
        "mfu": flops["flops_per_step"] / (ms / 1e3)
        / PEAK_FLOPS[torch.bfloat16],
        "mfu_peak_flops": PEAK_FLOPS[torch.bfloat16],
        "losses": losses, "grad_norms": norms, "lrs": lrs,
        "loss_drop": losses[0] - losses[-1], "launches": counts,
    }


# the smoke specs whose training the card holds against the CPU: dense
# (qwen3, minitron's gelu FFN), MQA (granite), alternating windows and
# softcaps (gemma2), MoE (deepseek-moe), MLA (deepseek-v2), the Mamba hybrid
# (jamba), RWKV6's chunk loop, encoder + cross-attention (whisper, frames in
# the batch), the vision prefix (internvl2)
TRAIN_PARITY_SPECS = PARITY_SPECS + ("rwkv6-7b",)
# fp32 on both sides, TF32 off: the loss within 1e-5 relative, every
# gradient leaf and every parameter after one step within 1e-4 x the leaf's
# largest |CPU value| + 1e-6 (the same arithmetic, sums in another order)
TRAIN_PARITY_TOL = dict(loss=1e-5, rel=1e-4, floor=1e-6)
# eps 1e-3 bounds how far Adam's first update g / (|g| + eps) moves with a
# gradient's last digits (by 1/eps), so the step compares within the bound
TRAIN_PARITY_OPT = dict(lr=1e-2, warmup=2, eps=1e-3)


def _leaf_errors(got, want) -> tuple:
    """(worst |got - want| / bound over the leaves, its leaf's index)."""
    worst, at = 0.0, None
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        w = w.float()
        bound = TRAIN_PARITY_TOL["rel"] * float(w.abs().max()) \
            + TRAIN_PARITY_TOL["floor"]
        share = float((g.detach().float().cpu() - w).abs().max()) / bound
        if share > worst:
            worst, at = share, i
    return worst, at


def phase_train_parity() -> dict:
    """Every family's smoke spec at fp32: the loss, every gradient and the
    parameters after one ``make_train_step`` step on the card against the
    same calls on the CPU (which the CPU tests hold against the JAX
    package).  Chunked attention in chunks of 16 over a [2, 32] batch, the
    CE in chunks of 8."""
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32",
                    attention_impl="chunked", attn_chunk=16, loss_chunk=8)
    rows = {}
    for name in TRAIN_PARITY_SPECS:
        spec = get_arch(name).smoke
        cpu_params = init_params(spec, rt, torch.Generator().manual_seed(3),
                                 device="cpu")
        params = lm._tree_map(lambda t: t.to(DEV), cpu_params)
        batch = TokenPipeline(DataCfg(global_batch=2, seq_len=32,
                                      vocab=spec.vocab, seed=3)).batch(0)
        rng = np.random.RandomState(3)
        for key, n in (("frames", spec.encoder_layers and spec.enc_seq),
                       ("vision", spec.vision_seq)):
            if n:
                batch[key] = rng.standard_normal(
                    (2, n, spec.d_model)).astype(np.float32)
        cpu_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        dev_batch = {k: t.to(DEV) for k, t in cpu_batch.items()}
        reset_counts()
        loss, grads = value_and_grad(params, dev_batch, spec, rt)
        want_loss, want_grads = value_and_grad(cpu_params, cpu_batch, spec,
                                                rt)
        step = make_train_step(spec, rt, OptCfg(**TRAIN_PARITY_OPT))
        stepped, _, m = step(params, init_opt_state(params), dev_batch)
        want_stepped, _, want_m = step(cpu_params, init_opt_state(cpu_params),
                                       cpu_batch)
        counts = {k: module.launches for k, module in COUNTERS.items()}
        loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        grad_share, grad_leaf = _leaf_errors(grads, want_grads)
        step_share, step_leaf = _leaf_errors(stepped, want_stepped)
        require(np.isfinite(float(loss)), f"{name}: the card's loss")
        require(loss_err <= TRAIN_PARITY_TOL["loss"],
                f"{name}: loss {float(loss)} on the card, "
                f"{float(want_loss)} on the CPU")
        require(grad_share <= 1.0, f"{name}: gradient leaf {grad_leaf} at "
                f"{grad_share} of its bound")
        require(step_share <= 1.0, f"{name}: parameter leaf {step_leaf} after "
                f"a step at {step_share} of its bound")
        require(all(n == 0 for n in counts.values()),
                f"{name}: training launched a kernel: {counts}")
        rows[spec.name] = {
            "loss": float(loss), "loss_rel_err": loss_err,
            "grad_leaves": len(leaves(grads)),
            "worst_grad_share_of_bound": grad_share,
            "worst_step_share_of_bound": step_share,
            "grad_norm": float(m["grad_norm"]),
            "grad_norm_cpu": float(want_m["grad_norm"])}
    return {"dtype": "float32", "tf32": False, "runtime": "chunked, "
            "attn_chunk 16, loss_chunk 8", "batch": [2, 32],
            "opt": TRAIN_PARITY_OPT, "tolerance": TRAIN_PARITY_TOL,
            "specs": rows, "refusals": check_refusals()}


def check_refusals() -> dict:
    """The forward-only kernels refuse to be differentiated on the card:
    ``ops.flash_attention``, ``ops.wkv6`` and ``ops.cost_reduce`` raise on a
    CUDA input that requires grad, before any launch; ``make_train_step``
    with ``attention_impl="cuda"`` raises at its first step (qwen3's smoke
    spec through flash attention, rwkv6's through wkv6).  A missing raise
    fails the run."""
    g = torch.Generator(device=DEV).manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=DEV, dtype=dtype)

    entries = {
        "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v),
                            [randn(1, 64, 2, 2, 64), randn(1, 64, 2, 64),
                             randn(1, 64, 2, 64)]),
        "wkv6": (lambda r, k, v, w, u, s0: ops.wkv6(r, k, v, w, u, s0,
                                                    chunk=32),
                 [randn(1, 64, 2, 64), randn(1, 64, 2, 64),
                  randn(1, 64, 2, 64), torch.rand((1, 64, 2, 64), generator=g,
                                                  device=DEV),
                  randn(2, 64), randn(1, 2, 64, 64)]),
        "cost_reduce": (ops.cost_reduce, [randn(4, 96, dtype=torch.float64),
                                          randn(8, 96, dtype=torch.float64)]),
    }

    def raises(fn, kernel) -> str:
        try:
            fn()
        except RuntimeError as e:
            require(kernel in str(e), f"{kernel} raised another error: {e}")
            return str(e)
        raise AssertionError(f"{kernel} did not refuse an input that "
                             "requires grad")

    out = {}
    reset_counts()
    for kernel, (entry, args) in entries.items():
        for i in range(len(args)):
            grad_args = [a.clone().requires_grad_(j == i)
                         for j, a in enumerate(args)]
            out[kernel] = raises(lambda: entry(*grad_args), kernel)
    refused_launches = {k: module.launches for k, module in COUNTERS.items()}
    require(all(n == 0 for n in refused_launches.values()),
            f"a refused call launched its kernel: {refused_launches}")
    for kernel, (entry, args) in entries.items():       # the kernels run
        entry(*args)
    require(all(module.launches == 1 for module in COUNTERS.values()),
            "a kernel did not run on inputs that need no grad")
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32")
    for name, kernel in (("qwen3-14b", "flash_attention"),
                         ("rwkv6-7b", "wkv6")):
        spec = get_arch(name).smoke
        params = init_params(spec, rt, torch.Generator(device=DEV)
                             .manual_seed(5), device=DEV)
        batch = {k: torch.from_numpy(v).to(DEV) for k, v in TokenPipeline(
            DataCfg(global_batch=2, seq_len=32, vocab=spec.vocab))
            .batch(0).items()}
        step = make_train_step(spec, rt, OptCfg())
        out[f"train_step {name} cuda"] = raises(
            lambda: step(params, init_opt_state(params), batch), kernel)
    return {"refused": sorted(out), "refused_launches": refused_launches}


# the ckpt phase's cell: deepseek-moe-16b at published widths (d_model
# 2048, 16 x 128, 64 routed experts top-6 + 2 shared of 1408, vocab
# 102400) cut to depth 2 of 28, its dense prefix layer and one MoE layer:
# 1.09 B parameters, a prefix list, a stacked slot with the "layers" and
# experts axes and the fp32 router beside bf16 leaves.  A checkpoint is
# 10 B a parameter (bf16 parameters, fp32 m and v): 10.9 GB.  The launcher's
# own runtime and optimizer (chunked attention, lr 1e-3, warmup 5)
CKPT = dict(arch="deepseek-moe-16b", widths=(28, 2048, 10944, 102400),
            layers=2, batch=2, seq=2048, steps=12, save_at=10)
CKPT_GAP = 1e-3               # resumed losses vs run A's, relative
CKPT_BYTES_PER_PARAM = 10
CKPT_SPACE = 1.25             # free space asked for, x the checkpoint


def leaf_digest(t: torch.Tensor) -> tuple:
    """(bytes, sum of the bytes, sum of byte x (position mod 65521 + 1)) of
    a tensor's bytes, computed on its device in chunks: a Fletcher-style
    check that a copy holds the same bits in the same places."""
    b = t.detach().contiguous().view(-1).view(torch.uint8)
    s1 = s2 = 0
    step = 1 << 26
    for c0 in range(0, b.numel(), step):
        c = b[c0:c0 + step].to(torch.int64)
        pos = torch.arange(c0, c0 + c.numel(), device=c.device) % 65521 + 1
        s1 += int(c.sum())
        s2 += int((c * pos).sum())
    return (b.numel(), s1, s2)


def axes_paths(tree, path: str = "") -> dict:
    """{checkpoint path: list of axis names} of an axes tree."""
    if isinstance(tree, dict):
        return {p: a for k in sorted(tree)
                for p, a in axes_paths(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: a for i, v in enumerate(tree)
                for p, a in axes_paths(v, f"{path}/{i}").items()}
    return {path: list(tree)}


def mount_of(path: str) -> dict:
    """The mount point and file system type that hold ``path``."""
    real, best = os.path.realpath(path), ("/", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    return {"mount": best[0], "fstype": best[1]}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def run_launcher(spec, ckpt_dir: str, steps: int) -> tuple:
    """``launch.train.train`` on the card: (its result, its printed lines).
    What it printed goes to standard error if it raises."""
    import io
    from repro_torch.launch import train as train_launcher
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = train_launcher.train(spec, steps=steps,
                                       batch=CKPT["batch"], seq=CKPT["seq"],
                                       ckpt_dir=ckpt_dir, device=DEV)
    except BaseException:
        sys.stderr.write(out.getvalue())
        raise
    return res, out.getvalue().splitlines()


def phase_ckpt() -> dict:
    """The training launcher's loop and the checkpoint module on the card
    (``CKPT``): run A trains 12 steps, saving at 10; run B trains to 10 in a
    fresh directory, its saved state is restored and held leaf by leaf
    against the state it saved (digests of the bytes, on the card), and a
    second launcher call resumes at 10 and trains to 12.  Each directory is
    deleted once read, so one checkpoint at most is on disk; free space is
    checked before each write and a shortage raises."""
    import shutil
    import tempfile
    from repro_torch.ckpt import restore
    spec = get_arch(CKPT["arch"]).spec
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == CKPT["widths"], "not the published deepseek-moe-16b")
    published_layers = spec.n_layers
    spec = dataclasses.replace(spec, n_layers=CKPT["layers"])
    require(lm.layer_pattern(spec) == (1, 1),
            "depth 2: the dense prefix layer and one stacked MoE slot")
    steps, save_at = CKPT["steps"], CKPT["save_at"]
    want_axes = axes_paths({"params": param_axes(spec)})
    need = CKPT_SPACE * CKPT_BYTES_PER_PARAM * spec.params()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    where = mount_of(root)

    def check_space():
        free = shutil.disk_usage(root).free
        require(free >= need, f"{root} ({where}): {free / 1e9:.2f} GB free, "
                f"a checkpoint needs {need / 1e9:.2f} GB")
        return free

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peaks below include it
    before_gb = torch.cuda.memory_allocated() / 1e9
    peaks = {}

    def mark(key):
        """The peak since the last mark; a new window starts."""
        torch.cuda.synchronize()
        peaks[key] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    reset_counts()
    try:
        # ---- run A: uninterrupted, saving at 10 ----
        free = check_space()
        a_dir = os.path.join(root, "a")
        t0 = time.perf_counter()
        run_a, lines_a = run_launcher(spec, a_dir, steps)
        wall_a = time.perf_counter() - t0
        mark("run A")
        step_dir = os.path.join(a_dir, f"step_{save_at:08d}")
        require(os.listdir(a_dir) == [f"step_{save_at:08d}"],
                f"run A left {os.listdir(a_dir)}")
        ckpt_bytes = dir_bytes(step_dir)
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
        got_axes = {e["path"]: e["axes"] for e in manifest["entries"]
                    if e.get("axes") is not None}
        require(got_axes == want_axes, "the manifest's axes are not "
                "param_axes(spec)")
        require(all(e["path"].startswith("/params/") or e["axes"] is None
                    for e in manifest["entries"]),
                "axes recorded outside the parameters")
        n_params = sum(t.numel() for t in leaves(run_a["params"]))
        losses_a = run_a["losses"]
        save_a = run_a["save_s"][save_at]
        step_s_a = run_a["step_s"]
        del run_a
        shutil.rmtree(a_dir)
        gc.collect()
        between_gb = torch.cuda.memory_allocated() / 1e9

        # ---- run B: to 10, restore, then resume to 12 ----
        check_space()
        b_dir = os.path.join(root, "b")
        run_b, lines_b = run_launcher(spec, b_dir, save_at)
        mark("run B to 10")
        saved = {"params": run_b["params"], "opt": run_b["opt"]}
        digests = [leaf_digest(t) for t in leaves(saved)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, at = restore(b_dir, saved, device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(at == save_at, f"restored step {at}")
        require(all(t.device == DEV for t in leaves(restored)),
                "a restored leaf off the card")
        require([t.dtype for t in leaves(restored)]
                == [t.dtype for t in leaves(saved)], "a restored dtype")
        bad = [i for i, (t, d) in enumerate(zip(leaves(restored), digests))
               if leaf_digest(t) != d]
        require(not bad, f"restored leaves {bad[:5]} differ from the saved")
        mark("restore")
        save_b = run_b["save_s"][save_at]
        losses_b0 = run_b["losses"]
        del restored, saved, run_b
        gc.collect()
        run_c, lines_c = run_launcher(spec, b_dir, steps)
        mark("resume to 12")
        require(f"resumed at step {save_at}" in lines_c,
                f"the rerun did not resume at {save_at}: {lines_c[:4]}")
        require(run_c["start"] == save_at and sorted(run_c["losses"])
                == list(range(save_at, steps)), "the resumed steps")
        losses_c = run_c["losses"]
        resume_s = run_c["resume_s"]
        del run_c
        shutil.rmtree(b_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = {k: module.launches for k, module in COUNTERS.items()}

    every = list(losses_a.values()) + list(losses_b0.values()) \
        + list(losses_c.values())
    require(all(np.isfinite(every)), f"a loss not finite: {every}")
    require(all(n == 0 for n in counts.values()),
            f"the launcher launched a kernel: {counts}")
    gap = max(abs(losses_c[s] - losses_a[s]) / abs(losses_a[s])
              for s in losses_c)
    require(gap <= CKPT_GAP, f"resumed losses {losses_c} vs {losses_a}: "
            f"gap {gap}")
    # the first step is the warm-up; the rest are timed, each ending in a
    # sync (launch.train)
    timed = [step_s_a[s] for s in sorted(step_s_a) if s > 0]
    return {
        "model": spec.name, "layers": spec.n_layers,
        "published_layers": published_layers,
        "reduced": [f"depth {spec.n_layers} of {published_layers} layers"],
        "params": n_params, "batch": [CKPT["batch"], CKPT["seq"]],
        "dir": where, "free_bytes_before": free,
        "checkpoint_bytes": ckpt_bytes,
        "save_s": [save_a, save_b],
        "save_gb_per_s": [ckpt_bytes / 1e9 / save_a,
                          ckpt_bytes / 1e9 / save_b],
        "restore_s": restore_s,
        "restore_gb_per_s": ckpt_bytes / 1e9 / restore_s,
        "resume_s": resume_s,
        "run_a_s": wall_a, "first_step_ms": step_s_a[0] * 1e3,
        "ms_per_step": 1e3 * sum(timed) / len(timed),
        "tokens_per_s": CKPT["batch"] * CKPT["seq"] * len(timed) / sum(timed),
        "peak_memory_gb": max(peaks.values()), "peak_gb_by_step": peaks,
        "allocated_before_gb": before_gb,
        "allocated_between_runs_gb": between_gb,
        "losses_a": [losses_a[s] for s in sorted(losses_a)],
        "losses_resumed": {s: losses_c[s] for s in sorted(losses_c)},
        "resume_gap": gap, "resume_tolerance": CKPT_GAP,
        "bit_equal": all(losses_c[s] == losses_a[s] for s in losses_c),
        "run_b_equals_a_to_10": all(losses_b0[s] == losses_a[s]
                                    for s in losses_b0),
        "launches": counts, "printed": lines_c[2:4],
    }


# ---------------------------------------------------------------------------
# shard: the ported sharding on a one-rank mesh of the card
# ---------------------------------------------------------------------------

SHARD = dict(train_arch=CKPT["arch"], train_widths=CKPT["widths"],
             train_layers=CKPT["layers"], batch=2, seq=2048, steps=6,
             serve_arch="qwen3-14b", serve_launches=5520)
SHARD_LOSS_REL = 1e-6         # mesh vs plain losses, relative, each step


def shard_train(mesh) -> dict:
    """Six steps plain, then six on the mesh from the same seed; then the
    placed state through save and ``restore(shardings=)``."""
    import shutil
    import tempfile
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import restore, save
    from repro_torch.launch.mesh import data_axes_of
    from repro_torch.models import AxisRules
    from repro_torch.parallel import distribute, param_shardings
    from repro_torch.train import opt_state_shardings
    spec = get_arch(SHARD["train_arch"]).spec
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == SHARD["train_widths"], "not the published deepseek-moe-16b")
    published_layers = spec.n_layers
    spec = dataclasses.replace(spec, n_layers=SHARD["train_layers"])
    # the training launcher's runtime and optimizer (launch/train.py)
    rt = RuntimeCfg(attention_impl="chunked", attn_chunk=SHARD["seq"])
    opt_cfg = OptCfg(lr=1e-3, warmup=5)
    rules_d = arch_rules(dataclasses.replace(get_arch(SHARD["train_arch"]),
                                             spec=spec), mesh)
    axes = param_axes(spec)
    pipe = TokenPipeline(DataCfg(global_batch=SHARD["batch"],
                                 seq_len=SHARD["seq"], vocab=spec.vocab,
                                 seed=0))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in pipe.batch(0).items()}

    def run(placed: bool) -> tuple:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(spec, rt, torch.Generator(device=DEV)
                             .manual_seed(0), device=DEV)
        shardings = None
        if placed:
            shardings = {
                "params": param_shardings(params, axes, rules_d, mesh),
                "opt": opt_state_shardings(params, axes, rules_d, mesh,
                                           zero1=True,
                                           data_axes=data_axes_of(mesh))}
            params = distribute(params, shardings["params"])
            opt = distribute(init_opt_state(params), shardings["opt"])
            step = make_train_step(spec, rt, opt_cfg,
                                   AxisRules(rules_d, mesh))
        else:
            opt = init_opt_state(params)
            step = make_train_step(spec, rt, opt_cfg)
        losses = []
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)          # warm-up
        losses.append(m["loss"])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(SHARD["steps"] - 1):
            params, opt, m = step(params, opt, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (SHARD["steps"] - 1)
        return {"params": params, "opt": opt}, shardings, {
            "ms_per_step": ms, "first_step_ms": first_ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": [float(x) for x in losses]}

    state, _, plain = run(False)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    del state
    state, shardings, placed = run(True)
    require(all(isinstance(t, DTensor) and t.device_mesh == mesh
                for t in leaves(state)), "a trained leaf off the mesh")
    gaps = [abs(a - b) / abs(b) for a, b in zip(placed["losses"],
                                                 plain["losses"])]
    require(all(np.isfinite(placed["losses"])) and max(gaps)
            <= SHARD_LOSS_REL, f"losses on the mesh {placed['losses']} "
            f"vs plain {plain['losses']}: gap {max(gaps)}")

    digests = [leaf_digest(t.to_local()) for t in leaves(state)]
    root = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(root, SHARD["steps"], state)
        save_s = time.perf_counter() - t0
        ckpt_bytes = dir_bytes(os.path.join(root,
                                            f"step_{SHARD['steps']:08d}"))
        t0 = time.perf_counter()
        back, at = restore(root, state, device=DEV, shardings=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(at == SHARD["steps"], f"restored step {at}")
    require(all(isinstance(t, DTensor) and tuple(t.placements)
                == tuple(w.placements) for t, w in zip(leaves(back),
                                                       leaves(state))),
            "a restored leaf is not placed as saved")
    bad = [i for i, (t, d) in enumerate(zip(leaves(back), digests))
           if leaf_digest(t.to_local()) != d]
    require(not bad, f"restored leaves {bad[:5]} differ from the saved")
    zero1 = sorted({str(t.placements) for t in leaves(state["opt"]["m"])})
    del back, state
    return {
        "model": spec.name, "layers": spec.n_layers,
        "published_layers": published_layers,
        "reduced": [f"depth {spec.n_layers} of {published_layers} layers"],
        "params": n_params, "batch": [SHARD["batch"], SHARD["seq"]],
        "rules": {k: v for k, v in rules_d.items() if v is not None},
        "plain": plain, "mesh": placed,
        "loss_gap_rel": max(gaps), "loss_tolerance": SHARD_LOSS_REL,
        "bit_equal": placed["losses"] == plain["losses"],
        "moment_placements": zero1, "checkpoint_bytes": ckpt_bytes,
        "save_s": save_s, "restore_s": restore_s,
        "restored_bit_equal": True,
    }


def shard_serve(mesh) -> dict:
    """The serve phase's requests and prefill for ``SHARD["serve_arch"]``,
    by the plain engine and by ``Engine(rules=)`` over placed parameters;
    counts set to 0 before each run and read after it."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import AxisRules
    from repro_torch.parallel import distribute, param_shardings
    name = SHARD["serve_arch"]
    spec = get_arch(name).spec
    require((spec.n_layers, spec.d_model, spec.d_ff, spec.vocab)
            == SERVED[name]["widths"], f"not the published {name}")
    rt = RuntimeCfg()                    # bf16, attention through the kernel
    rules_d = arch_rules(get_arch(name), mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(spec, rt, torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    slots, n_req, max_new, kv_len = 8, 16, 16, 2048
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, spec.vocab, size=rng.randint(16, 65))
               for _ in range(n_req)]
    tokens = torch.from_numpy(rng.randint(0, spec.vocab, size=(2, 2048))) \
        .to(DEV)

    def serve(p, rules) -> dict:
        engine = Engine(spec, rt, p, batch_slots=slots, kv_len=kv_len,
                        device=DEV, rules=rules)
        for rid, prompt in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=prompt, max_new=max_new))

        def prefill(pp, tok):
            return lm.forward(pp, tok, spec, rt, rules)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run(max_steps=kv_len)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        logits, first = timed_prefill(prefill, p, tokens)
        counts = {k: module.launches for k, module in COUNTERS.items()}
        placed = isinstance(logits, DTensor)
        last = (logits.full_tensor() if placed else logits)[:, -1].float()
        del logits
        warm = [timed_prefill(prefill, p, tokens)[1]["ms"] for _ in range(3)]
        require(len(done) == n_req and all(len(r.out) == max_new
                                           for r in done),
                f"served {len(done)}/{n_req}")
        require(bool(torch.isfinite(last).all()), "prefill logits not finite")
        return {"tokens": {r.rid: r.out for r in done},
                "decode_steps": engine.steps,
                "decode_ms_per_step": decode_s * 1e3 / engine.steps,
                "prefill_first_ms": first["ms"],
                "prefill_ms": float(np.median(warm)),
                "prefill_warm_ms_readings": warm, "launches": counts,
                "logits_are_dtensors": placed, "last_logits": last}

    plain = serve(params, None)
    placed_params = distribute(params, param_shardings(
        params, param_axes(spec), rules_d, mesh))
    placed = serve(placed_params, AxisRules(rules_d, mesh))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(placed["logits_are_dtensors"], "the mesh's logits are plain")
    require(placed["tokens"] == plain["tokens"],
            "greedy tokens on the mesh differ from the plain engine's")
    for run in (plain, placed):
        require(run["launches"]["flash_attention"] == SHARD["serve_launches"]
                and run["launches"]["wkv6"] == run["launches"][
                    "cost_reduce"] == 0,
                f"launches {run['launches']}, expected "
                f"{SHARD['serve_launches']} flash")
    logit_gap = float((placed.pop("last_logits")
                       - plain.pop("last_logits")).abs().max())
    del placed_params, params
    for run in (plain, placed):
        run.pop("tokens")
        run.pop("logits_are_dtensors")
    return {"model": spec.name, "layers": spec.n_layers,
            "rules": {k: v for k, v in rules_d.items() if v is not None},
            "requests": n_req, "slots": slots, "kv_len": kv_len,
            "plain": plain, "mesh": placed, "tokens_equal": True,
            "last_logits_max_abs_gap": logit_gap,
            "peak_memory_gb": peak_gb}


def phase_shard() -> dict:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        require(dist.get_backend() == "nccl", "the mesh is not on NCCL")
        train = shard_train(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        serve = shard_serve(mesh)
    finally:
        dist.destroy_process_group()
    return {"mesh": {"shape": [1, 1], "names": ["data", "model"],
                     "backend": "nccl"},
            "train": train, "serve": serve}


# ---------------------------------------------------------------------------
# dryrun: the multi-pod dry run's cells, and its accounting against a real
# step on the card
# ---------------------------------------------------------------------------

# (arch, shape, multi-pod): FSDP on 16x16; the expert-parallel all-to-all
# on 2x16x16; the cache sharded over its layers dimension (the JAX
# package's heuristic: minitron's 32 layers divide the data degree 16); a
# prefill at 32k tokens (counted by two shallower runs, dryrun.REPEATS)
DRYRUN_CELLS = (("qwen3-14b", "train_4k", False),
                ("deepseek-moe-16b", "train_4k", True),
                ("minitron-8b", "decode_32k", False),
                ("qwen3-14b", "prefill_32k", False))
DRYRUN_TIMEOUT_S = 900
# the card check: the train phase's qwen3-14b (published width, its depth,
# TRAIN_RT), one step of [TRAIN_BATCH, TRAIN_SEQ]; the dry run's predicted
# peak within this share of torch.cuda.max_memory_allocated()
CARD_PEAK_REL = 0.05


def dryrun_cells(out_dir: str) -> list:
    """Start one ``python -m repro_torch.launch.dryrun`` per cell, all at
    once (each owns its fake process group), writing under ``out_dir``;
    returns [(cell, process, output path)]."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    started = []
    for arch, shape, multipod in DRYRUN_CELLS:
        out = os.path.join(out_dir, f"{arch}_{shape}_{int(multipod)}.jsonl")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out] \
            + (["--multipod"] if multipod else [])
        started.append(((arch, shape, multipod), subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True), out))
    return started


def dryrun_records(started: list) -> list:
    """Each started cell's record, once its process ended: status OK, and
    the counts positive and finite."""
    records = []
    for (arch, shape, multipod), proc, out in started:
        try:
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        require(proc.returncode == 0,
                f"dryrun {arch} {shape}: exit {proc.returncode}: "
                f"{err[-2000:]}")
        with open(out) as f:
            rec = json.loads(f.read().splitlines()[-1])
        require(rec["status"] == "OK",
                f"dryrun {arch} {shape}: {rec['status']} "
                f"{rec.get('error')} {rec.get('trace', '')[-1500:]}")
        for key in ("flops_per_dev", "bytes_per_dev",
                    "peak_memory_per_dev_gb"):
            require(np.isfinite(rec[key]) and rec[key] > 0,
                    f"dryrun {arch} {shape}: {key} {rec[key]}")
        records.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "chips", "flops_per_dev",
            "bytes_per_dev", "collective_bytes_per_dev", "collectives",
            "peak_memory_per_dev_gb", "args_gb", "temp_gb", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant", "useful_flops_ratio",
            "trace_wall_s")} | {"repeats": rec.get("repeats"),
                               "stage_step_ms":
                               rec["stage_predict"].get("step_ms"),
                               "stage_peak_gb":
                               rec["stage_predict"].get("peak_gb")})
    return records


def card_check() -> dict:
    """One training step of the train phase's model through the dry run's
    helper on a one-rank mesh of the card: under fake tensors, then for
    real under the same counting mode.  FLOPs and bytes must be equal, the
    predicted peak within ``CARD_PEAK_REL`` of the allocator's; the
    roofline time beside the measured ms/step (the step again, uncounted,
    one warm-up and three timed)."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    name = "qwen3-14b"
    arch = get_arch(name)
    require((arch.spec.n_layers, arch.spec.d_model, arch.spec.d_ff,
             arch.spec.vocab) == TRAINED[name]["widths"],
            f"not the published {name}")
    arch = dataclasses.replace(arch, spec=dataclasses.replace(
        arch.spec, n_layers=TRAINED[name]["layers"]))
    shape = ShapeSpec("card_check", TRAIN_SEQ, TRAIN_BATCH, "train")
    rt = RuntimeCfg(**TRAIN_RT)
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        fake, _ = dryrun.lower_on(arch, shape, mesh, rt=rt)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cell = dryrun.prepare(arch, shape, mesh, rt=rt, fake=False)
        real = dryrun.count(cell)
        measured = torch.cuda.max_memory_allocated() - base
        cell.step(*cell.args)                      # warm-up, uncounted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            cell.step(*cell.args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        del cell
    finally:
        dist.destroy_process_group()
    for key in ("flops", "bytes", "collectives"):
        require(fake[key] == real[key],
                f"card check: {key} fake {fake[key]} != real {real[key]}")
    peak_rel = abs(fake["peak_bytes"] - measured) / measured
    require(peak_rel <= CARD_PEAK_REL,
            f"card check: predicted peak {fake['peak_bytes']} B vs "
            f"measured {measured} B ({peak_rel:.4f} > {CARD_PEAK_REL})")
    t_compute = fake["flops"] / dryrun.PEAK_FLOPS
    t_memory = fake["bytes"] / dryrun.HBM_BW
    roofline_ms = max(t_compute, t_memory) * 1e3
    return {"arch": name, "layers": TRAINED[name]["layers"],
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "runtime": TRAIN_RT,
            "flops": fake["flops"], "bytes": fake["bytes"],
            "flops_equal": True, "bytes_equal": True,
            "predicted_peak_bytes": fake["peak_bytes"],
            "args_bytes": fake["args_bytes"],
            "counted_real_peak_bytes": real["peak_bytes"],
            "measured_peak_bytes": measured,
            "peak_rel_err": peak_rel, "peak_limit": CARD_PEAK_REL,
            "t_compute_ms": t_compute * 1e3, "t_memory_ms": t_memory * 1e3,
            "roofline_ms": roofline_ms, "ms_per_step": ms,
            "ms_over_roofline": ms / roofline_ms,
            "fake_trace_s": fake["trace_wall_s"],
            "real_counted_s": real["trace_wall_s"]}


def phase_dryrun() -> dict:
    """The dry run's cells in subprocesses (started first, on the host's
    cores), the card check on the card meanwhile, then the cells'
    records."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        started = dryrun_cells(out_dir)
        try:
            check = card_check()
            records = dryrun_records(started)
        finally:
            for _, proc, _ in started:    # stop what is left after a failure
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {"cells": records, "card_check": check,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}; the result "
                         "line is printed only after all of them")
    ap.add_argument("--ptxas-info", action="store_true",
                    help="also compile with -Xptxas -v and print registers, "
                         "shared memory and spills to standard error")
    ap.add_argument("--profile", action="store_true",
                    help="serve phase: also trace four decode steps and "
                         "one warm prefill with torch.profiler (device-busy "
                         "time, idle share, top kernels); sweep phase: the "
                         "same for one warm evaluation of the sweep's points")
    ap.add_argument("--models", default=",".join(SERVED),
                    help="serve phase: comma-separated subset of the served "
                         "models (a subset makes the run partial)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    models = [m for m in args.models.split(",") if m]
    if set(models) - set(SERVED):
        ap.error(f"unknown models {sorted(set(models) - set(SERVED))}")

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kind=kind, nvidia_smi=smi,
         count=torch.cuda.device_count())

    kernels: list = []
    if "build" in phases:
        t0 = time.perf_counter()
        built = _build.build_all()
        emit("build", seconds=time.perf_counter() - t0, built=sorted(built),
             sources=_build.sources(), flags=list(_build.NVCC_FLAGS))
        if args.ptxas_info:
            logs = _build.build_all(extra_flags=("-Xptxas", "-v"))
            for name, log in logs.items():
                sys.stderr.write(f"---- ptxas: {name} ----\n{log}\n")
    if "kernels" in phases:
        kernels = phase_kernels()
        if not {"serve", "sweep", "api", "analysis"} & set(phases):
            probe_library_backends()
            print(json.dumps({"kernels": kernels}), flush=True)
    main_paths = {"serve", "sweep", "api", "analysis"} & set(phases)
    if main_paths and not kernels:
        ap.error("the serve, sweep, api and analysis phases need the kernels "
                 "phase")
    if "serve" in phases:
        for name in models:
            emit("serve", **phase_serve(name, kernels,
                                        with_profile=args.profile))
            gc.collect()                 # free one model before the next
            torch.cuda.empty_cache()
    if "sweep" in phases:
        emit("sweep", **phase_sweep(kernels, with_profile=args.profile))
    if "api" in phases:
        emit("api", **phase_api(kernels))
    if "analysis" in phases:
        emit("analysis", **phase_analysis(kernels))
    if main_paths:
        # ``launches`` is the count of each kernel's first main path (the
        # api and analysis phases require and report their own counts)
        served = {SERVED[m]["kernel"] for m in models} \
            if "serve" in phases else set()
        paths = {f"serve {m}" for m in models}
        for k in kernels:
            if k["name"] in served or (k["name"] == "cost_reduce" and {
                    "sweep", "analysis"} & set(phases)):
                require(k["launches"] > 0,
                        f"kernel {k['name']} never ran on the main path")
                for iname, inst in k.get("instances", {}).items():
                    require(inst["launches"] > 0 or inst["path"] not in paths,
                            f"{k['name']} {iname} never ran on its path")
        probe_library_backends()
        print(json.dumps({"kernels": kernels}), flush=True)
    if "parity" in phases:
        # fp32 products in full fp32 on the card, as on the CPU (the
        # defaults), and float16 products summed in fp32, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            False
        for dtype in PARITY_TOL:
            for name in PARITY_SPECS:
                emit("parity", **phase_parity(dtype, name))
            emit("parity", **phase_parity_rwkv(dtype))
    if "train" in phases:
        # fp32 products (RWKV6's chunk, the parity's smoke specs) in full
        # fp32, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for name in TRAINED:
            emit("train", **phase_train(name))
            gc.collect()                 # free one model before the next
            torch.cuda.empty_cache()
        emit("train-parity", **phase_train_parity())
    if "ckpt" in phases:
        emit("ckpt", **phase_ckpt())
    if "shard" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        emit("shard", **phase_shard())
    if "dryrun" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        emit("dryrun", **phase_dryrun())

    if set(phases) != set(PHASES) or models != list(SERVED):
        print(json.dumps({"ok": False, "partial": phases, "models": models}),
              flush=True)
        return 2
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
