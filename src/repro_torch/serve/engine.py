"""Batched serving engine: prefill + decode with a static KV budget.

``serve_step`` is one token for the whole batch against a ``kv_len`` cache.
The engine adds simple continuous batching on top: finished sequences release
their slot and queued requests claim it.

Two properties carried over from the JAX engine, so that both produce the
same greedy tokens: all slots share one position counter that advances every
step, and a freed slot's cache rows are not reset, so a request admitted
later attends to what earlier occupants of the slot wrote.  A run of an
attention model therefore needs ``kv_len`` >= its total number of steps; a
step past ``kv_len`` raises.  For a recurrent model (RWKV6) the slot's state
is not reset either: a later request inherits the recurrent state that the
slot's earlier occupants left, and empty slots keep stepping on token 0.

Each step counts itself in the ``repro_torch.obs`` registry, always
(``engine.slot_steps``: slots stepped, empty ones included,
``engine.generated``: tokens served; their ratio is the share of slot
steps that served a token), and with tracing on records the spans
``engine.step`` > ``engine.tokens`` (the token batch built and copied to
the device), ``engine.forward`` (``step_fn``: the host enqueueing the
decode step) and ``engine.sync`` (the argmax and its copy back: the host
waiting for the device).

With ``rules`` and parameters placed on a mesh (DTensors), the engine's
cache is placed on the same mesh, its batch dimension over the mesh's data
axes where it divides, everything else replicated (the layers dimension of
a stacked leaf must stay whole: ``decode_step`` writes through its rows).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models import lm
from ..launch.mesh import data_axes_of
from ..obs import metrics
from ..obs.spans import span
from ..models.common import AxisRules, RuntimeCfg, _tree_map, mesh_of, whole
from ..parallel.sharding import (NamedSharding, batch_pspec, distribute,
                                 mesh_sizes)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                       # [Tp] int32
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


def make_serve_step(spec, rt: RuntimeCfg, rules: Optional[AxisRules] = None):
    def serve_step(params, cache, tokens):
        """tokens [B, 1] -> (logits [B, 1, V], cache); the cache's tensors
        are updated in place."""
        return lm.decode_step(params, cache, tokens, spec, rt, rules)
    return serve_step


def make_prefill(spec, rt: RuntimeCfg, rules: Optional[AxisRules] = None):
    def prefill(params, tokens):
        """Full-batch prefill -> last-position logits (the engine fills its
        cache token by token through serve_step).  Serving records no
        autograd graph."""
        with torch.no_grad():
            return lm.forward(params, tokens, spec, rt, rules)[:, -1:]
    return prefill


def engine_cache_shardings(cache: dict, mesh) -> dict:
    """The engine's cache layout on ``mesh``: the batch dimension (dim 0 of
    a prefix layer's leaf, dim 1 of a stacked slot's) over the mesh's
    ``pod`` / ``data`` axes where it divides; ``pos`` and every other
    dimension replicated."""
    da = data_axes_of(mesh)
    sizes = mesh_sizes(mesh)
    deg = int(np.prod([sizes[a] for a in da]))

    def by_batch_dim(bdim):
        def one(t):
            if not isinstance(t, torch.Tensor):
                return NamedSharding(mesh, ())
            spec: list = [None] * t.dim()
            if da and t.shape[bdim] % deg == 0:
                spec[bdim] = batch_pspec(da)[0]
            return NamedSharding(mesh, tuple(spec))
        return one
    return {"prefix": [_tree_map(by_batch_dim(0), c)
                       for c in cache["prefix"]],
            "slots": [_tree_map(by_batch_dim(1), c)
                      for c in cache["slots"]]}


class Engine:
    """Slot-based continuous batching over ``serve_step``.

    ``params`` must already lie on ``device`` (the card unless
    ``device="cpu"``); placed on a mesh, the cache goes there too
    (``engine_cache_shardings``) and ``rules`` constrain the activations."""

    def __init__(self, spec, rt: RuntimeCfg, params, *, batch_slots: int,
                 kv_len: int, device=None,
                 rules: Optional[AxisRules] = None):
        self.device = resolve_device(device)
        self.spec, self.rt, self.params = spec, rt, params
        self.kv_len = kv_len
        self.slots: list = [None] * batch_slots
        self.cache = lm.init_cache(spec, rt, batch_slots, kv_len,
                                   device=self.device)
        mesh = mesh_of(params)
        if mesh is not None:
            self.cache = distribute(
                self.cache, engine_cache_shardings(self.cache, mesh))
        self.step_fn = make_serve_step(spec, rt, rules)
        self.queue: list = []
        self.steps = 0                       # decode steps taken so far
        self._n_slot_steps = metrics.counter("engine.slot_steps")
        self._n_generated = metrics.counter("engine.generated")

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                req = self.queue.pop(0)
                req._fed = 0
                self.slots[i] = req

    def run(self, max_steps: int = 64) -> list:
        """Greedy-decode all queued requests; returns finished requests."""
        finished: list = []
        self._admit()
        for _ in range(max_steps):
            if all(s is None for s in self.slots) and not self.queue:
                break
            with span("engine.step", step=self.steps):
                finished += self._step()
        return finished

    def _step(self) -> list:
        """One decode step of every slot, then admission; returns the
        requests it finished."""
        finished, generated = [], 0
        with span("engine.tokens"):
            # build the batched token: prompts feed first, then argmax
            tok_host = np.zeros((len(self.slots), 1), np.int64)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if req._fed < len(req.prompt):
                    tok_host[i, 0] = req.prompt[req._fed]
                    req._fed += 1
                elif req.out:
                    tok_host[i, 0] = req.out[-1]
            tokens = torch.from_numpy(tok_host).to(self.device)
        with span("engine.forward"):
            logits, self.cache = self.step_fn(self.params, self.cache, tokens)
        self.steps += 1
        with span("engine.sync"):
            nxt = torch.argmax(whole(logits)[:, 0], dim=-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req._fed >= len(req.prompt):
                req.out.append(int(nxt[i]))
                generated += 1
            if len(req.out) >= req.max_new:
                req.done = True
                finished.append(req)
                self.slots[i] = None
        self._admit()
        self._n_slot_steps.inc(len(self.slots))
        self._n_generated.inc(generated)
        return finished
