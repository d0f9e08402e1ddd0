"""AdamW with fp32 moments over parameters in their own dtype (bf16 in
training), global grad-norm clipping and a warmup + cosine schedule: own
copy of ``repro.train.optimizer`` in PyTorch.

Functional, as the JAX package's: ``adamw_update`` returns new parameters
and a new state and leaves its arguments as they were.  Each leaf's
temporaries are updated in place, so only about two fp32 copies of the
largest leaf are alive beside the new state.  On a mesh the leaves are
DTensors and ``opt_state_shardings`` places the moments ZeRO-1 (each
parameter's spec plus the data axes on its first free dimension that
divides); the update then runs on the moments' shards, and each new
parameter is gathered back to its own placements."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.common import _tree_map
from ..parallel.sharding import NamedSharding, mesh_sizes, param_pspec
from .tree import leaves, unflatten


@dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptCfg, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int32 tensor or an int), fp32: a linear
    warmup over ``cfg.warmup`` steps, then a cosine from ``lr`` down to
    0.1 * lr at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * (step + 1) / max(1, cfg.warmup)
    prog = torch.clamp((step - cfg.warmup)
                       / max(1, cfg.total_steps - cfg.warmup), 0.0, 1.0)
    cos = 0.1 * cfg.lr + 0.45 * cfg.lr * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup, warm, cos)


def init_opt_state(params) -> dict:
    """fp32 zeros ``m`` and ``v`` shaped (and, for DTensors, placed) like
    ``params``, and ``step``, an int32 0 on the parameters' device (a plain
    tensor: ``parallel.distribute`` places it by ``opt_state_shardings``)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    flat = leaves(params)
    return {"m": unflatten(params, [zeros(p) for p in flat]),
            "v": unflatten(params, [zeros(p) for p in flat]),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device)}


def opt_state_shardings(params, axes, rules: dict, mesh, *,
                        zero1: bool = True,
                        data_axes: tuple = ("pod", "data")) -> dict:
    """Moments sharded like params (``param_pspec`` over ``params``' shapes
    and the logical ``axes``), plus (ZeRO-1) the data axes on the first
    free dimension that divides by them, where no data axis shards the
    parameter yet.  The JAX package's specs: padded to the leaf's rank,
    not trimmed.  Returns ``{"m", "v", "step"}`` of ``NamedSharding``;
    ``step`` is replicated."""
    sizes = mesh_sizes(mesh)
    deg = int(math.prod(sizes[n] for n in data_axes))
    data_entry = data_axes if len(data_axes) != 1 else data_axes[0]

    def one(p, ax):
        ndim = len(p.shape)
        spec = (list(param_pspec(tuple(p.shape), ax, rules, mesh))
                + [None] * ndim)[:ndim]
        if zero1:
            flat_data = [a for e in spec if e
                         for a in (e if isinstance(e, tuple) else (e,))]
            if not any(a in flat_data for a in data_axes):
                for d in range(ndim):
                    if spec[d] is None and p.shape[d] % deg == 0:
                        spec[d] = data_entry
                        break
        return NamedSharding(mesh, tuple(spec))

    m = _tree_map(one, params, axes)
    return {"m": m, "v": m, "step": NamedSharding(mesh, ())}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (on a mesh each
    leaf's sum is reduced over its shards)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))


def adamw_update(params, grads, opt_state: dict, cfg: OptCfg) -> tuple:
    """One AdamW step.  ``grads`` is shaped like ``params``.  Returns (new
    params in each leaf's dtype, new state ``{"m", "v", "step"}``,
    ``{"grad_norm", "lr"}``).  Leaves of one dimension (norm scales) get no
    weight decay."""
    step = opt_state["step"]
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    t = (step + 1).float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        gf = g.float() * scale
        m2 = m * cfg.b1
        m2 += (1 - cfg.b1) * gf
        v2 = v * cfg.b2
        sq = (1 - cfg.b2) * gf
        sq *= gf
        v2 += sq
        del gf, sq
        upd = m2 / bc1
        upd /= (v2 / bc2).sqrt_().add_(cfg.eps)
        decay = cfg.weight_decay if p.dim() > 1 else 0.0
        pv = p.to(torch.float32, copy=True)
        upd += decay * pv
        upd *= lr
        pv -= upd
        del upd
        new_p.append(pv.to(p.dtype))
        new_m.append(m2)
        new_v.append(v2)

    return (unflatten(params, new_p),
            {"m": unflatten(opt_state["m"], new_m),
             "v": unflatten(opt_state["v"], new_v), "step": step + 1},
            {"grad_norm": gnorm, "lr": lr})
