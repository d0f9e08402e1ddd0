"""What both load generators share: the host clock, device syncs and events."""
from __future__ import annotations

import time

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """A timestamp at the end of each step's device work: a CUDA event
    recorded behind it on the card (read once the window has closed), the
    host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms_between(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def log_uniform_pool(lo: int, hi: int, n: int) -> list:
    """``n`` lengths at the midpoints of ``n`` equal slices of [log lo,
    log hi]: the same set for every seed."""
    import math
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / n
                               * (math.log(hi) - math.log(lo)))))
            for i in range(n)]
