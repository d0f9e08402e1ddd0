"""Fault tolerance + resilience modeling (pure python, no torch).

Failure domains and goodput math live here so the DSE sweep workers can
import them without pulling in the torch runtime; checkpoint I/O is
``repro_torch.ckpt``.
"""
from .elastic import ElasticPlan, elastic_reshard, reshard_cost, shrink_cfg
from .failures import FailureDomain, FailureEvent, FailureModel, FailureTrace
from .goodput import (CKPT_TIERS, LOCAL_SSD, OBJECT_STORE, PARALLEL_FS,
                      CkptTier, ReplayEvent, ReplayResult, ResilienceReport,
                      ResilienceSpec, checkpoint_cost, expected_goodput,
                      overhead_curve, peer_goodput, replay_goodput,
                      restore_cost, score_point, score_serving_point,
                      state_bytes, young_daly_interval)
from .stragglers import (Decision, StragglerModel, StragglerWatchdog,
                         drive_watchdog, elastic_mesh_shape)

__all__ = [
    "CKPT_TIERS", "LOCAL_SSD", "OBJECT_STORE", "PARALLEL_FS", "CkptTier",
    "Decision", "ElasticPlan", "FailureDomain", "FailureEvent",
    "FailureModel", "FailureTrace", "ReplayEvent", "ReplayResult",
    "ResilienceReport", "ResilienceSpec", "StragglerModel",
    "StragglerWatchdog", "checkpoint_cost", "drive_watchdog",
    "elastic_mesh_shape", "elastic_reshard", "expected_goodput",
    "overhead_curve", "peer_goodput", "replay_goodput", "reshard_cost",
    "restore_cost", "score_point", "score_serving_point", "shrink_cfg",
    "state_bytes", "young_daly_interval",
]
