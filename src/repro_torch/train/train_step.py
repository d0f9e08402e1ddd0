"""The training step: loss -> grad -> (compress) -> AdamW, own copy of
``repro.train.train_step`` in eager PyTorch.

Gradient accumulation runs the micro-batches one after the other, summing
their gradients into fp32; the optional top-k compression with error
feedback sits between the gradients and the optimizer.  With ``rules`` and
parameters placed on a mesh (DTensors, ``repro_torch.parallel``) the step
runs on the mesh: the loss, its backward and the update under
``models.common.on_mesh``; the metrics come back as plain tensors."""
from __future__ import annotations

from typing import Optional

import torch

from ..models import lm
from ..models.common import (AxisRules, RuntimeCfg, mesh_of, on_mesh, settle,
                             whole)
from .compress import topk_compress_decompress
from .optimizer import OptCfg, adamw_update
from .tree import leaves, unflatten


def value_and_grad(params, batch: dict, spec, rt: RuntimeCfg,
                   rules: Optional[AxisRules] = None) -> tuple:
    """(loss, grads shaped like ``params`` in each leaf's dtype); a leaf the
    loss does not reach gets zeros, as under ``jax.grad``.  On a mesh the
    gradients are DTensors placed as their parameters and the loss a plain
    scalar."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad(), on_mesh(mesh_of(params)):
        loss = lm.loss_fn(unflatten(params, flat), batch, spec, rt, rules)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else
                 _placed_like(g, p) for p, g in zip(flat, grads)]
    return whole(loss.detach()), unflatten(params, grads)


def _placed_like(g, p):
    """A DTensor gradient in its parameter's placements."""
    from torch.distributed.tensor import DTensor
    return settle(g, p.placements) if isinstance(p, DTensor) else g


def make_train_step(spec, rt: RuntimeCfg, opt_cfg: OptCfg,
                    rules: Optional[AxisRules] = None, *,
                    grad_accum: int = 1, compress_ratio: float = 0.0):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics ``{"loss", "grad_norm", "lr"}``).

    ``batch`` holds tensors on the parameters' device: ``tokens`` and
    ``labels`` [B, S], and ``frames`` / ``vision`` where the spec takes
    them.  Without accumulation the gradients are in each parameter's
    dtype; with ``grad_accum`` > 1 the batch is cut along B into that many
    micro-batches, their gradients summed into fp32 zeros and scaled by
    1 / grad_accum, as is the loss.  ``rules`` (``AxisRules``) constrain the
    activations of parameters placed on a mesh, as in the JAX package.  ``opt_state`` may carry an ``ef``
    error-feedback buffer, which compression (``compress_ratio`` > 0) reads
    and renews.  Parameters and state are new tensors; the caller's are
    left as they were, the ``opt_state`` dict included.

    The attention and wkv6 kernels have no backward: a runtime with
    ``attention_impl="cuda"`` raises at the first step; train with
    ``"chunked"``."""

    def grads_of(params, batch):
        if grad_accum <= 1:
            return value_and_grad(params, batch, spec, rt, rules)
        b = batch["tokens"].shape[0]
        mb = b // grad_accum
        acc_l = None
        acc_g = [torch.zeros_like(p, dtype=torch.float32,
                                  memory_format=torch.contiguous_format)
                 for p in leaves(params)]
        for i in range(grad_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l, g = value_and_grad(params, micro, spec, rt, rules)
            acc_l = l.float() if acc_l is None else acc_l + l
            for a, gi in zip(acc_g, leaves(g)):
                a += gi
        scale = 1.0 / grad_accum
        return acc_l * scale, unflatten(params, [a * scale for a in acc_g])

    def train_step(params, opt_state: dict, batch: dict) -> tuple:
        with on_mesh(mesh_of(params)):
            return _step(params, opt_state, batch)

    def _step(params, opt_state: dict, batch: dict) -> tuple:
        loss, grads = grads_of(params, batch)
        metrics = {"loss": loss}
        opt_state = dict(opt_state)           # the caller's dict stays whole
        if compress_ratio > 0:
            grads, opt_state["ef"] = topk_compress_decompress(
                grads, opt_state.get("ef"), ratio=compress_ratio)
        ef = opt_state.pop("ef", None)
        core = {k: opt_state[k] for k in ("m", "v", "step")}
        params, core, om = adamw_update(params, grads, core, opt_cfg)
        new_opt = dict(core)
        if ef is not None:
            new_opt["ef"] = ef
        metrics.update({k: whole(v) for k, v in om.items()})
        return params, new_opt, metrics

    return train_step
