"""AdamW with fp32 moments over parameters in their own dtype (bf16 in
training), global grad-norm clipping and a warmup + cosine schedule: own
copy of ``repro.train.optimizer`` in PyTorch.

Functional, as the JAX package's: ``adamw_update`` returns new parameters
and a new state and leaves its arguments as they were.  Each leaf's
temporaries are updated in place, so only about two fp32 copies of the
largest leaf are alive beside the new state.  ``opt_state_shardings``
(ZeRO-1) waits for the sharding slice."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

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
    """fp32 zeros ``m`` and ``v`` shaped like ``params``, and ``step``, an
    int32 0 on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    flat = leaves(params)
    return {"m": unflatten(params, [zeros(p) for p in flat]),
            "v": unflatten(params, [zeros(p) for p in flat]),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
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
