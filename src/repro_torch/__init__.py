"""PyTorch/CUDA twin of the ``repro`` runtime, for NVIDIA Hopper.

A second package beside the JAX one: it imports ``torch``, sympy and numpy,
never ``jax`` and nothing of ``repro``.  What it needs from a framework-free
module of ``repro`` it keeps as its own copy (the generator in ``core/``,
``ft/``, ``obs/`` and ``api.py``).  Same sub-package and module names as
``repro`` where a counterpart exists.

Front door — the fluent pipeline API (see :mod:`repro_torch.api`):

    from repro_torch import Scenario, H100_HGX

    trace = (Scenario(spec)
             .train(batch=64, seq=2048)
             .parallel(dp=8, tp=4)
             .trace())
    trace.simulate(H100_HGX).ms, trace.memory().peak_gb
    (Scenario(spec).train(batch=64, seq=2048).with_backend("batched")
     .sweep(64, H100_HGX))             # on the card, through cost_reduce

Also ported: the serving path of dense GQA decoders (qwen3-14b) and of
RWKV6 (rwkv6-7b) in :mod:`repro_torch.models` / :mod:`repro_torch.serve`.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such request they raise.
"""
from ._device import resolve_device, torch_dtype
from .api import (Job, Phase, Scenario, Trace, clear_graph_cache,
                  compiled_cache_stats, graph_cache_stats)
from .core import (H100_HGX, H100_HGX_POD, TPU_V5E, TPU_V5E_POD,
                   ClusterTopology, HardwareProfile, InfeasibleConfigError,
                   MLASpec, ModelSpec, MoESpec, ParallelCfg, SSMSpec,
                   SweepResult, Tier)
from .core.serving import DecodeSeries, JobResult, PhaseResult
from .ft.goodput import CkptTier, ResilienceSpec
from .ft.stragglers import StragglerModel

__all__ = [
    "Scenario", "Trace", "Phase", "Job", "JobResult", "PhaseResult",
    "DecodeSeries", "graph_cache_stats", "clear_graph_cache",
    "compiled_cache_stats", "ModelSpec", "MoESpec", "MLASpec", "SSMSpec",
    "ParallelCfg", "SweepResult", "InfeasibleConfigError",
    "HardwareProfile", "TPU_V5E", "H100_HGX", "TPU_V5E_POD", "H100_HGX_POD",
    "ClusterTopology", "Tier",
    "ResilienceSpec", "CkptTier", "StragglerModel",
    "resolve_device", "torch_dtype",
]
