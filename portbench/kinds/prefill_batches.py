"""Back-to-back prefill batches through the port's ``serve.engine.
make_prefill`` (``lm.forward``, last-position logits): each batch holds
``tokens_per_batch`` prompt tokens as B prompts of one length S.  S cycles
through ``seq_lens`` in an order the seed shuffles; the window runs whole
cycles, so every window holds each length in equal shares.  Token ids are
drawn from the seed on the device (``token_rows`` rows of a batch's worth,
batch i taking row i mod token_rows)."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline
from .common import sync


class Load:
    def __init__(self, ctx):
        self.ctx = ctx
        mix = ctx.mix
        self.tpb = mix["tokens_per_batch"]
        rng = np.random.default_rng([ctx.seed, 2])
        self.order = [int(s) for s in rng.permutation(mix["seq_lens"])]
        self.check_rng = rng
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(int(ctx.seed) % (1 << 63) ^ 0x5DEECE66D)
        self.rows = torch.randint(1, ctx.cfg["vocab_size"],
                                  (mix["token_rows"], self.tpb), generator=gen,
                                  device=ctx.device)
        self.done = []           # (batch index, S, last-position logits)
        self.n = 0

    def tokens(self, i: int) -> torch.Tensor:
        s = self.order[i % len(self.order)]
        return self.rows[i % self.rows.shape[0]].view(self.tpb // s, s)

    def batch(self, keep: bool) -> None:
        toks = self.tokens(self.n)
        out = self.prefill(self.ctx.tree, toks)
        sync(self.ctx.device)
        if keep:
            self.done.append((self.n, toks.shape[1], out[:, 0].clone()))
        self.n += 1

    def setup(self) -> None:
        from repro_torch.serve.engine import make_prefill
        self.prefill = make_prefill(self.ctx.spec, self.ctx.rt)
        for _ in self.order:             # each length once
            self.batch(keep=False)

    def measure(self, seconds: float) -> dict:
        sync(self.ctx.device)
        n0 = self.n
        t0 = time.perf_counter()
        while True:
            for _ in self.order:
                self.batch(keep=True)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        batches = self.n - n0
        tokens = batches * self.tpb
        attended = sum(self.tpb * (s + 1) // 2 for _, s, _ in self.done)
        return {"window_s": wall, "batches": batches, "tokens": tokens,
                "prefill_tok_s": tokens / wall,
                "model_flops": roofline.model_flops(self.ctx.cfg, tokens,
                                                    attended),
                "finished": batches}

    def trace(self, profile) -> dict:
        cycles = self.ctx.mix["trace_cycles"]
        sync(self.ctx.device)
        with profile() as prof:
            t0 = time.perf_counter()
            for _ in range(cycles * len(self.order)):
                self.batch(keep=False)
            wall = time.perf_counter() - t0
        return {"prof": prof, "wall_s": wall,
                "tokens": cycles * len(self.order) * self.tpb}

    def release(self) -> None:
        self.prefill = None

    def judged(self) -> list:
        """Batches of each prompt length, drawn from the seed among the
        window's batches: as many as the cell's ``judged_batches`` gives
        the length, else the mix's ``check_per_length``."""
        pick = []
        for s_len in sorted(set(self.order), reverse=True):
            mine = [d for d in self.done if d[1] == s_len]
            n = self.ctx.judged_batches.get(str(s_len),
                                            self.ctx.mix["check_per_length"])
            for j in self.check_rng.permutation(len(mine))[:n]:
                pick.append(mine[j])
        return pick

    def check(self, ref, control=None) -> dict:
        """Per judged batch and prompt, the program's last-position logits
        against the reference's: ``logit_rel_err`` (the largest
        ||program - reference|| / ||reference|| over the prompts) and
        ``top_gap`` (the widest gap by which the program's top token lies
        below the reference's best).  With a ``control`` in the program's
        place, the same as ``control.<name>``."""
        worst = {"logit_rel_err": 0.0, "top_gap": 0.0}
        if control is not None:
            worst.update({"control.logit_rel_err": 0.0, "control.top_gap": 0.0})
        rows = {k: [] for k in worst}
        count = 0
        for i, s, got in self.judged():
            toks = self.tokens(i)
            want = ref.logits(ref.hidden(toks, "batch")[:, -1])
            sides = {"": got.float()}
            if control is not None:
                sides["control."] = control.logits(
                    control.hidden(toks, "batch")[:, -1])
            best = want.max(-1).values
            for pre, lg in sides.items():
                rel = (lg - want).norm(dim=-1) / want.norm(dim=-1)
                gap = best - want.gather(1, lg.argmax(-1)[:, None])[:, 0]
                worst[pre + "logit_rel_err"] = max(worst[pre + "logit_rel_err"],
                                                   float(rel.max()))
                worst[pre + "top_gap"] = max(worst[pre + "top_gap"],
                                             float(gap.max()))
                rows[pre + "logit_rel_err"].append(rel)
                rows[pre + "top_gap"].append(gap)
            count += toks.shape[0]
        for name, parts in rows.items():
            worst[name + ".mean"] = float(torch.cat(parts).mean())
        worst["judged"] = count
        return worst
