"""Elastic shrink: re-shard costing for a world - k rank loss.

When recovery replaces failed hardware the job resumes at full world
size, but an *elastic* policy instead continues on the surviving ranks:
shrink the mesh, re-run the distributor on the smaller grid, and pay a
one-time re-shard of the persistent state.  This module models that
transition:

* :func:`shrink_cfg` — the shrunken :class:`ParallelCfg`: the data axis
  absorbs the loss (model parallelism degrees are baked into the graph
  partitioning; dp is the only axis that shrinks without re-planning
  the whole model), matching ``ft.stragglers.elastic_mesh_shape``.
* :func:`reshard_cost` — bytes and seconds to rebalance state onto the
  survivors, charged through the real
  :class:`~repro_torch.core.collectives.CollectiveModel`: replicated-dp
  configs move nothing (every survivor already holds full state), while
  FSDP/ZeRO-1 shards must be re-gathered to the coarser partition.
* :func:`elastic_reshard` — the full transition: build a fresh graph,
  distribute it on the shrunken mesh (validating feasibility), and
  return an :class:`ElasticPlan` with both the costs and the new
  distribution report.

Pure python (no torch), like the rest of :mod:`repro_torch.ft`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .goodput import state_bytes as _state_bytes

__all__ = ["ElasticPlan", "shrink_cfg", "reshard_cost", "elastic_reshard"]


@dataclass(frozen=True)
class ElasticPlan:
    """Outcome of a world - k elastic shrink."""
    old_world: int
    new_world: int
    ranks_lost: int            # actually dropped (>= requested k: whole
                               # dp replicas go at a time)
    cfg: object                # the shrunken ParallelCfg
    reshard_bytes: float       # per-survivor bytes moved
    reshard_time: float        # seconds for the re-shard collectives
    dist_report: object = None  # DistReport from the shrunken distribute


def shrink_cfg(cfg, k: int):
    """The config after losing ``k`` ranks: dp shrinks, everything else
    (tp/cp/ep/pp, schedule, placement) is preserved.  Because only whole
    data-parallel replicas can be dropped (each replica spans the full
    model mesh), the new dp degree is ``(world - k) // model_ranks`` —
    the largest replica count fitting the survivors.  Raises when the
    config has no dp slack to give."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    world = cfg.world
    if k >= world:
        raise ValueError(f"cannot lose k={k} of world={world} ranks")
    dp = cfg.degree(cfg.dp_axis) if cfg.dp_axis else 1
    model_ranks = world // dp
    new_dp = (world - k) // model_ranks
    if new_dp < 1:
        raise ValueError(
            f"losing k={k} ranks leaves {world - k} < one model replica "
            f"({model_ranks} ranks); config {cfg.describe()} cannot shrink")
    if new_dp == dp:
        raise ValueError(
            f"k={k} is less than one dp replica ({model_ranks} ranks); "
            "nothing to shrink")
    axes = dict(cfg.axes)
    axes[cfg.dp_axis] = new_dp
    return replace(cfg, axes=axes)


def reshard_cost(cfg, new_cfg, mem, hw) -> tuple[float, float]:
    """``(bytes, seconds)`` per survivor to rebalance persistent state
    after the shrink.

    ``mem`` is the OLD config's memory report.  Replicated dp moves
    nothing.  FSDP/ZeRO-1 shard (weights+opt+master for FSDP, optimizer
    state for ZeRO-1) over dp, so each survivor's shard grows by
    ``old/new - 1`` of its old size; that delta arrives over the dp-axis
    fabric, charged as an AllGather on the NEW (shrunken) group."""
    from ..core.collectives import comm_model
    dp_old = cfg.degree(cfg.dp_axis) if cfg.dp_axis else 1
    dp_new = new_cfg.degree(new_cfg.dp_axis) if new_cfg.dp_axis else 1
    if not (cfg.fsdp or cfg.zero1) or dp_old <= dp_new:
        return 0.0, 0.0
    if cfg.fsdp:
        sharded = _state_bytes(mem)
    else:                                  # zero1: optimizer side only
        sharded = float(mem.opt_states + mem.master_params)
    delta = sharded * (dp_old / dp_new - 1.0)
    if delta <= 0 or dp_new <= 1:
        # dp_new == 1 with a sharded config: the survivor gathers the
        # whole state; charge it as a point-to-point drain
        if delta <= 0:
            return 0.0, 0.0
        cm = comm_model(hw, new_cfg)
        t = cm.time_of({"coll": "SendRecv", "axis": cfg.dp_axis, "group": 2,
                        "size": delta, "wire": delta})
        return delta, t
    cm = comm_model(hw, new_cfg)
    t = cm.time_of({"coll": "AllGather", "axis": cfg.dp_axis,
                    "group": dp_new, "size": delta, "wire": delta})
    return delta, t


def elastic_reshard(build, env, cfg, k: int, hw, *, mem=None) -> ElasticPlan:
    """Plan a world - k shrink end to end.

    ``build`` is a zero-arg callable returning a FRESH graph (the same
    convention as :func:`repro_torch.core.dse.sweep` — ``distribute`` rewrites
    graphs in place, so the shrunken mesh gets its own copy).  ``mem``
    (the old config's memory report) enables the re-shard byte/time
    charge; without it the plan carries zero cost but still validates
    that the shrunken config distributes cleanly."""
    from ..core.distribute import distribute
    new_cfg = shrink_cfg(cfg, k)
    graph = build()
    report = distribute(graph, new_cfg, env)
    if mem is not None:
        nbytes, t = reshard_cost(cfg, new_cfg, mem, hw)
    else:
        nbytes, t = 0.0, 0.0
    return ElasticPlan(old_world=cfg.world, new_world=new_cfg.world,
                       ranks_lost=cfg.world - new_cfg.world, cfg=new_cfg,
                       reshard_bytes=nbytes, reshard_time=t,
                       dist_report=report)
