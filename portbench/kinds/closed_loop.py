"""Closed-loop decode through the port's serving engine (``serve.Engine``):
one client per slot, each sending its next request as soon as the previous
one finishes, greedy decoding.

Lengths: prompt and output lengths each from a fixed pool of
``length_pool`` log-uniform values, in an order drawn from the mix's
``length_seed``, so every seed serves the same sizes at the same steps; the
seed draws the prompts' token ids (and the weights).  Each slot's first
request starts part-way through its life (``residual_life``: a uniform
share of its prompt and output already behind it).

The engine's slots share one position counter, so every step attends to as
many keys as the engine has taken steps.  Set-up drives the closed loop up
to step ``window_at_step``, and the window opens there: a fixed point in the
middle of the engine's life, which admits requests until the next position
plus the longest life would pass ``kv_len``.  When the slots have drained
a new engine starts over the same weights.

Bookkeeping is taken from outside the engine: the step function it calls is
wrapped to note which request sits in each slot at each step and to mark
the step's end on the device.  From that and the requests' prompts and
served tokens this module rebuilds each slot's history from the engine's
first step (the tokens fed at every position of an engine that never resets
a slot) for the reference, which judges the requests finished in the
window."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline
from .common import StepClock, log_uniform_pool, sync


class Load:
    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.slots, self.kv_len = mix["slots"], mix["kv_len"]
        n = mix["length_pool"]
        lrng = np.random.default_rng(mix.get("length_seed", 0))
        self.prompt_pool = [log_uniform_pool(*mix["prompt_tokens"], n)[i]
                            for i in lrng.permutation(n)]
        self.output_pool = [log_uniform_pool(*mix["output_tokens"], n)[i]
                            for i in lrng.permutation(n)]
        self.life_rng = lrng
        self.max_life = mix["prompt_tokens"][1] + mix["output_tokens"][1]
        self.tok_rng = np.random.default_rng([ctx.seed, 1])
        self.vocab = ctx.cfg["vocab_size"]
        self.next_rid = 0
        self.req = {}            # rid -> Request
        self.where = {}          # rid -> (epoch, first step)
        self.done_at = {}        # rid -> global step at whose end it finished
        self.epochs = []         # per engine: list of per-step slot rids
        self.clock = StepClock(ctx.device)
        self.step_global = 0     # steps taken over all engines
        self.admitting = True
        self.eng = None
        if mix["window_at_step"] + self.max_life > self.kv_len:
            raise ValueError("window_at_step + the longest life passes kv_len:"
                             " the window would open after admission stops")

    # -- traffic ----------------------------------------------------------
    def _request(self, first: bool):
        from repro_torch.serve.engine import Request
        k = self.next_rid
        self.next_rid += 1
        tp = self.prompt_pool[k % len(self.prompt_pool)]
        to = self.output_pool[k % len(self.output_pool)]
        prompt = self.tok_rng.integers(1, self.vocab, size=tp)
        if first and self.ctx.mix.get("residual_life"):
            behind = int(self.life_rng.integers(0, tp + to))
            if behind < tp:
                prompt = prompt[behind:]
            else:
                prompt, to = prompt[-1:], max(1, to - (behind - tp))
        r = Request(rid=k, prompt=prompt.astype(np.int64), max_new=int(to))
        self.req[k] = r
        return r

    def _new_engine(self, first: bool) -> None:
        from repro_torch.serve.engine import Engine
        if self.eng is not None:
            self.eng.cache = None
            self.eng = None
        ctx = self.ctx
        eng = Engine(ctx.spec, ctx.rt, ctx.tree, batch_slots=self.slots,
                     kv_len=self.kv_len, device=ctx.device)
        occ = []
        self.epochs.append(occ)
        epoch = len(self.epochs) - 1
        inner = eng.step_fn

        def step(params, cache, tokens):
            rids = tuple(None if r is None else r.rid for r in eng.slots)
            t = len(occ)
            for rid in rids:
                if rid is not None and rid not in self.where:
                    self.where[rid] = (epoch, t)
            occ.append(rids)
            out = inner(params, cache, tokens)
            self.clock.mark()
            return out
        eng.step_fn = step
        self.eng = eng
        self.admitting = True
        for _ in range(self.slots):
            eng.submit(self._request(first))

    def step(self) -> None:
        """One engine step; finished clients send their next request."""
        eng = self.eng
        before = eng.steps
        finished = eng.run(max_steps=1)
        if eng.steps == before:             # drained: a new engine
            self._new_engine(first=False)
            finished = self.eng.run(max_steps=1)
        for r in finished:
            self.done_at[r.rid] = self.step_global
        self.step_global += 1
        if self.admitting and self.eng.steps + self.max_life > self.kv_len:
            self.admitting = False
        if self.admitting:
            for _ in finished:
                self.eng.submit(self._request(False))

    # -- phases -----------------------------------------------------------
    def setup(self) -> None:
        self._new_engine(first=True)
        while self.eng.steps < self.ctx.mix["window_at_step"]:
            self.step()

    def measure(self, seconds: float) -> dict:
        dev = self.ctx.device
        sync(dev)
        k0 = self.step_global
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step()                      # ends in the argmax's sync
        sync(dev)
        wall = time.perf_counter() - t0
        self.window = (k0, self.step_global)
        return self._window_numbers(k0, self.step_global, wall)

    def _steps(self):
        """(global step, epoch, step in epoch, slot rids) of every step."""
        g = 0
        for e, occ in enumerate(self.epochs):
            for t, rids in enumerate(occ):
                yield g, e, t, rids
                g += 1

    def _generates(self, rid, t) -> bool:
        return t - self.where[rid][1] >= len(self.req[rid].prompt) - 1

    def _window_numbers(self, k0, k1, wall) -> dict:
        gen_steps = np.zeros(k1 - k0, np.int64)
        itl_w = np.zeros(k1 - k0, np.int64)
        occupied, attended = 0, 0
        prev = None
        for g, e, t, rids in self._steps():
            if g >= k1:
                break
            gen = {rid for rid in rids if rid is not None
                   and self._generates(rid, t)}
            if g >= k0:
                gen_steps[g - k0] = len(gen)
                if prev is not None and g > k0:
                    itl_w[g - k0] = len(gen & prev)
                busy = [rid for rid in rids if rid is not None]
                occupied += len(busy)
                attended += len(busy) * (t + 1)
            prev = gen
        gaps = np.array([self.clock.ms_between(g - 1, g)
                         for g in range(k0 + 1, k1)])
        samples = np.repeat(gaps, itl_w[1:])
        generated = int(gen_steps.sum())
        flops = roofline.model_flops(self.ctx.cfg, occupied, attended)
        finished = sum(1 for rid, g in self.done_at.items() if k0 <= g < k1)
        return {"window_s": wall, "steps": k1 - k0, "generated": generated,
                "decode_tok_s": generated / wall,
                "itl_p95_ms": float(np.percentile(samples, 95))
                if samples.size else None,
                "itl_samples": int(samples.size),
                "slot_steps": self.slots * (k1 - k0),
                "gen_share": generated / (self.slots * (k1 - k0)),
                "model_flops": flops, "finished": finished}

    def trace(self, profile) -> dict:
        """``trace_steps`` steps after the window, under ``profile``."""
        n = self.ctx.mix["trace_steps"]
        sync(self.ctx.device)
        with profile() as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                self.step()
            sync(self.ctx.device)
            wall = time.perf_counter() - t0
        return {"prof": prof, "wall_s": wall, "steps": n}

    def release(self) -> None:
        self.eng.cache = None
        self.eng = None

    # -- the output check -------------------------------------------------
    def histories(self) -> list:
        """Per engine whose requests finished in the window: the tokens
        fed [slots, T] from the engine's first step and the served tokens
        of those requests to judge, as (slot, step, token)."""
        k0, k1 = self.window
        judged = {rid for rid, g in self.done_at.items() if k0 <= g < k1}
        out = []
        for e, occ in enumerate(self.epochs):
            mine = [rid for rid in judged if self.where[rid][0] == e]
            if not mine:
                continue
            T = max(self.where[rid][1] + len(self.req[rid].prompt)
                    + self.req[rid].max_new - 1 for rid in mine)
            fed = np.zeros((self.slots, T), np.int64)
            served = []
            for t in range(T):
                for i, rid in enumerate(occ[t]):
                    if rid is None:
                        continue
                    r = self.req[rid]
                    pos, tp = t - self.where[rid][1], len(r.prompt)
                    fed[i, t] = r.prompt[pos] if pos < tp else r.out[pos - tp]
                    if pos >= tp - 1 and rid in judged:
                        served.append((i, t, r.out[pos - tp + 1]))
            out.append({"fed": fed, "served": served})
        return out

    def check(self, ref, control=None) -> dict:
        """``served_gap``: the widest gap by which a served token's logit
        lies below the best of the reference's logits at its position.
        With a ``control`` (a reference in a lower precision) put in the
        program's place, ``control.served_gap``: the same for the token the
        control puts first at each of those positions."""
        worst = {"served_gap": 0.0}
        if control is not None:
            worst["control.served_gap"] = 0.0
        gaps = {k: [] for k in worst}
        count = 0
        for h in self.histories():
            fed = torch.from_numpy(h["fed"]).to(self.ctx.device)
            hid = ref.hidden(fed, "step")
            chid = control.hidden(fed, "step") if control is not None else None
            served = h["served"]
            for b0 in range(0, len(served), 1024):
                blk = served[b0:b0 + 1024]
                ii = [s[0] for s in blk]
                tt = [s[1] for s in blk]
                logits = ref.logits(hid[ii, tt])
                best = logits.max(-1).values
                picks = {"served_gap": torch.tensor(
                    [s[2] for s in blk], device=logits.device)}
                if chid is not None:
                    picks["control.served_gap"] = \
                        control.logits(chid[ii, tt]).argmax(-1)
                for name, tok in picks.items():
                    gap = best - logits.gather(1, tok[:, None])[:, 0]
                    worst[name] = max(worst[name], float(gap.max()))
                    gaps[name].append(gap)
                count += len(blk)
        for name, parts in gaps.items():
            # a window that finished no request has nothing to show: its
            # numbers read infinite and fail every limit
            g = torch.cat(parts) if parts else torch.full((1,), float("inf"))
            worst[name + ".mean"] = float(g.mean())
            worst[name + ".p99"] = float(torch.quantile(g, 0.99))
            worst[name + ".nonzero"] = float((g > 0).float().mean())
        worst["judged"] = count
        return worst
