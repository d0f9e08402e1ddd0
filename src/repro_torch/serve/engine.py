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
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..models import lm
from ..models.common import RuntimeCfg


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                       # [Tp] int32
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


def make_serve_step(spec, rt: RuntimeCfg):
    def serve_step(params, cache, tokens):
        """tokens [B, 1] -> (logits [B, 1, V], cache); the cache's tensors
        are updated in place."""
        return lm.decode_step(params, cache, tokens, spec, rt)
    return serve_step


def make_prefill(spec, rt: RuntimeCfg):
    def prefill(params, tokens):
        """Full-batch prefill -> last-position logits (the engine fills its
        cache token by token through serve_step).  Serving records no
        autograd graph."""
        with torch.no_grad():
            return lm.forward(params, tokens, spec, rt)[:, -1:]
    return prefill


class Engine:
    """Slot-based continuous batching over ``serve_step``.

    ``params`` must already lie on ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, spec, rt: RuntimeCfg, params, *, batch_slots: int,
                 kv_len: int, device=None):
        self.device = resolve_device(device)
        self.spec, self.rt, self.params = spec, rt, params
        self.kv_len = kv_len
        self.slots: list = [None] * batch_slots
        self.cache = lm.init_cache(spec, rt, batch_slots, kv_len,
                                   device=self.device)
        self.step_fn = make_serve_step(spec, rt)
        self.queue: list = []
        self.steps = 0                       # decode steps taken so far

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
            logits, self.cache = self.step_fn(self.params, self.cache, tokens)
            self.steps += 1
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                if req._fed >= len(req.prompt):
                    req.out.append(int(nxt[i]))
                if len(req.out) >= req.max_new:
                    req.done = True
                    finished.append(req)
                    self.slots[i] = None
            self._admit()
        return finished
