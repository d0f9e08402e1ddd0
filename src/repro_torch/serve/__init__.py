"""Serving: the runtime engine (continuous batching over decode steps) and
the symbolic phase-program front door.

The runtime half (:class:`Engine`) executes real decode steps on the card;
the symbolic half (:class:`repro_torch.api.Job` /
:class:`repro_torch.core.serving.JobResult`) predicts the same request
timeline — TTFT / TPOT / tokens/s / KV footprint — in closed form,
so capacity planning never needs a device:

    from repro_torch.serve import Job
    job = Scenario(spec).prefill(batch=8, seq=1024).parallel(tp=8) \\
        .generation(out_tokens=512)
    job.evaluate(H100_HGX).describe()
"""
from ..api import Job, Phase
from ..core.serving import DecodeSeries, JobResult, PhaseResult
from .engine import Engine, Request, make_prefill, make_serve_step

__all__ = ["Engine", "Request", "make_prefill", "make_serve_step",
           "Job", "Phase", "JobResult", "PhaseResult", "DecodeSeries"]
