"""Traffic is a deterministic function of the seed: the same seed gives the
same inputs; another seed the same sizes with other token ids."""
from types import SimpleNamespace

import numpy as np
import torch

from portbench.kinds import closed_loop, prefill_batches
from portbench.tests.helpers import load, smoke


def _ctx(cell, seed):
    s = smoke(cell)
    return SimpleNamespace(mix=s["mix"], cfg=s["cfg"], seed=seed,
                           device=torch.device("cpu"))


def _requests(seed, n=24):
    d = closed_loop.Load(_ctx("jamba52b.decode-chat8", seed))
    return [d._request(first=i < d.slots) for i in range(n)]


def test_closed_loop_requests_follow_the_seed():
    a, b, c = _requests(2 ** 31 + 5), _requests(2 ** 31 + 5), _requests(7)
    assert [(r.prompt.tolist(), r.max_new) for r in a] == \
        [(r.prompt.tolist(), r.max_new) for r in b]
    assert [(len(r.prompt), r.max_new) for r in a] == \
        [(len(r.prompt), r.max_new) for r in c]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_closed_loop_lengths_are_the_pool():
    mix = load("decode-small")
    d = closed_loop.Load(_ctx("jamba52b.decode-chat8", 3))
    lo, hi = mix["prompt_tokens"]
    assert sorted(d.prompt_pool) == sorted(
        closed_loop.log_uniform_pool(lo, hi, mix["length_pool"]))
    assert all(lo <= n <= hi for n in d.prompt_pool)


def test_prefill_batches_follow_the_seed():
    def batches(seed):
        d = prefill_batches.Load(_ctx("jamba52b.prefill-mix8k", seed))
        return d.order, [d.tokens(i).clone() for i in range(6)]
    (oa, ta), (ob, tb), (oc, tc) = batches(11), batches(11), batches(12)
    assert oa == ob and all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert sorted(oa) == sorted(oc)
    assert all(t.numel() == load("prefill-small")["tokens_per_batch"]
               for t in ta)
    assert not all(torch.equal(x.flatten(), y.flatten())
                   for x, y in zip(ta, tc))
