"""Symbolic pre-flight advisor for the runtime drivers.

Before a driver compiles or trains anything, run the same (spec,
workload, parallelization) through the STAGE Scenario pipeline and
report predicted step time / peak memory / communication.  Pure
sympy — costs milliseconds, needs no devices — so every launch gets a
sanity check against the analytic model for free, and dry-run records
carry the symbolic prediction next to the XLA-measured numbers.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import Scenario, TPU_V5E
from repro_torch.core import HardwareProfile, ModelSpec


def preflight(spec: ModelSpec, *, mode: str = "train", batch: int, seq: int,
              kv_len: Optional[int] = None, dp: int = 1, tp: int = 1,
              sp: Optional[bool] = None, fsdp: bool = False,
              zero1: bool = False, ep=False,
              hw: HardwareProfile = TPU_V5E) -> dict:
    """One-line symbolic estimate (see :meth:`repro_torch.api.Trace.summary`)."""
    sc = Scenario(spec)
    if mode == "train":
        sc = sc.train(batch=batch, seq=seq)
    elif mode == "decode":
        sc = sc.decode(batch=batch, kv_len=kv_len or seq)
    else:
        sc = sc.prefill(batch=batch, seq=seq)
    if dp > 1 and batch % dp != 0:
        dp = 1                    # unshardable batch: estimate single-replica
    sc = sc.parallel(dp=dp, tp=tp, sp=sp, fsdp=fsdp, zero1=zero1, ep=ep)
    return sc.trace().summary(hw)


def announce(tag: str, summary: dict) -> None:
    print(f"[{tag}] STAGE pre-flight: {summary['scenario']} -> "
          f"step ~{summary['step_ms']}ms, peak ~{summary['peak_gb']}GB, "
          f"overlap {summary['overlap']:.0%} on {summary['hw']}", flush=True)
