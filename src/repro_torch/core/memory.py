"""Peak per-device memory model from tensor lifetimes (paper §V-B, Table V).

The paper feeds STAGE graphs to ASTRA-sim and post-processes tensor
read/write events into lifetimes ("from creation to last use, assuming
garbage collection immediately thereafter").  We compute the same
quantity directly on the instantiated graph:

* **Persistent** state — weights, gradients (held across microbatches by
  grad accumulation), optimizer moments (fp32 m+v), optional fp32 master
  params — all at their *storage* sharding (so FSDP/ZeRO shrink them).
* **Activations** — alive from producer to last consumer.  Tensors
  produced by ops tagged ``fused`` (flash-attention internals) die at
  their last *forward* consumer; with ``recompute`` (Fig 11) every
  activation dies at the end of its layer's forward and the backward
  working set is bounded by one layer's activations.
* **Pipeline in-flight factor** — derived from the configured pipeline
  schedule's slot timeline (:mod:`repro_torch.core.schedules`): 1F1B keeps
  ``min(microbatches, pp - s)`` microbatches of activations alive on
  stage ``s``, GPipe all ``microbatches``, interleaved a fractional
  chunk count, ZB-H1 the 1F1B bound (activations die at ``bwd_in``).

This is the REFERENCE memory model; ``CostProgram.peak_memory`` in
:mod:`repro_torch.core.compiled` mirrors it term-for-term (same accumulation
order, same event-sweep semantics) for bit-identical numeric replay —
keep both in sync (tests/test_backend_parity.py enforces it).
"""
from __future__ import annotations

from dataclasses import dataclass

from .distribute import ParallelCfg
from .graphdist import PipelinePlan
from .schedules import inflight_factor
from .stg import Comm, Graph, Update
from .symbolic import Env, prod
from .tensor import DTYPE_BYTES, STensor


@dataclass
class MemoryReport:
    weights: float
    grads: float
    opt_states: float
    master_params: float
    peak_activation: float
    inflight_factor: float      # schedule-derived (fractional: interleaved)
    recompute_extra: float

    @property
    def peak_bytes(self) -> float:
        return (self.weights + self.grads + self.opt_states + self.master_params
                + self.peak_activation * self.inflight_factor
                + self.recompute_extra)

    @property
    def peak_gb(self) -> float:
        return self.peak_bytes / 2**30


def _local_bytes(t: STensor, env: Env, mesh: dict[str, int]) -> float:
    return (env.fevaluate(prod(t.local_shape(mesh)))) * DTYPE_BYTES[t.dtype]


def kv_cache_bytes(graph: Graph, cfg: ParallelCfg, env: Env, *,
                   local: bool = False) -> float:
    """Bytes of the KV-cache state a decode graph reads: the root inputs
    whose shape depends on the KV length symbol ``Skv`` (k/v caches for
    GQA, latent+rope caches for MLA).  ``local=True`` returns one rank's
    shard (mesh-axis sharding per tensor plus an even per-stage layer
    split for ``pp > 1``); the default is the GLOBAL cache — the
    quantity a prefill→decode handoff must ship between pools,
    invariant under either pool's sharding/placement (reference for the
    compiled decode series' ``kv_bytes``)."""
    from .symbolic import sym
    skv = sym("Skv")
    mesh = cfg.mesh if local else {}
    total = 0.0
    for t in graph.inputs:
        if any(skv in getattr(d, "free_symbols", ())
               for d in t.shape):
            shape = t.local_shape(mesh) if local else t.shape
            total += env.fevaluate(prod(shape)) * DTYPE_BYTES[t.dtype]
    if local:
        total /= max(1, cfg.pp)
    return total


def peak_memory(graph: Graph, cfg: ParallelCfg, env: Env,
                plan: PipelinePlan | None = None, *, stage: int = 0,
                recompute: bool = False, master_fp32: bool = True,
                grad_dtype: str = "fp32") -> MemoryReport:
    mesh = cfg.mesh
    stage_of = plan.op_stage if plan else {}
    ops = [op for op in graph.ops if stage_of.get(op.uid, 0) == stage]

    # ---- persistent state -------------------------------------------------
    weights = grads = opt_states = master = 0.0
    stage_weights: set[int] = set()
    for op in ops:
        for t in op.ins:
            if t.kind == "weight" and t.uid not in stage_weights:
                stage_weights.add(t.uid)
                weights += _local_bytes(t, env, mesh)
        if isinstance(op, Update):
            w, g = op.ins
            shard = op.outs[1].spec                      # opt-state sharding
            m_bytes = (env.fevaluate(prod(w.shape))) * 4
            deg = shard.degree(mesh)
            opt_states += 2 * m_bytes / deg              # fp32 m + v
            if master_fp32:
                master += m_bytes / deg
            grads += ((env.fevaluate(prod(w.shape)))
                      * DTYPE_BYTES[grad_dtype] / g.spec.degree(mesh))

    # ---- activation lifetimes ----------------------------------------------
    produced_at: dict[int, int] = {}
    last_use: dict[int, int] = {}
    last_fwd_use: dict[int, int] = {}
    tensors: dict[int, STensor] = {}
    for i, op in enumerate(ops):
        for t in op.ins:
            if t.kind == "act":
                last_use[t.uid] = i
                if op.phase == "fwd":
                    last_fwd_use[t.uid] = i
        for t in op.outs:
            # kind=="grad" (weight grads) live in the persistent bucket
            if t.kind == "act":
                produced_at[t.uid] = i
                last_use[t.uid] = max(last_use.get(t.uid, i), i)
                tensors[t.uid] = t

    fused = {t.uid for op in ops if op.tags.get("fused")
             for t in op.outs}

    layer_act: dict[object, float] = {}
    events: list[tuple[int, float]] = []
    for uid, start in produced_at.items():
        t = tensors[uid]
        end = last_use.get(uid, start)
        b = _local_bytes(t, env, mesh)
        die_fwd = uid in fused or recompute
        if die_fwd:
            end = min(end, last_fwd_use.get(uid, start))
        if recompute and t.producer is not None:
            lyr = t.producer.tags.get("layer")
            if lyr is not None and uid not in fused:
                layer_act[lyr] = layer_act.get(lyr, 0.0) + b
        events.append((start, b))
        events.append((end + 1, -b))
    events.sort()
    cur = peak = 0.0
    for _, delta in events:
        cur += delta
        peak = max(peak, cur)

    pp = plan.pp if plan else 1
    inflight = inflight_factor(getattr(cfg, "schedule", "1f1b"), pp,
                               cfg.microbatches, getattr(cfg, "vstages", 1),
                               stage)
    recompute_extra = max(layer_act.values(), default=0.0) if recompute else 0.0
    return MemoryReport(weights=weights, grads=grads, opt_states=opt_states,
                        master_params=master, peak_activation=peak,
                        inflight_factor=inflight,
                        recompute_extra=recompute_extra)
