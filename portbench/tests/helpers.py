"""Smoke-size runs of the harness on the CPU."""
import contextlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import torch

DATA = Path(__file__).resolve().parent / "data"
# (config, traffic, window in seconds of ``fixed_clock``): 100 decode steps,
# two prefill cycles; sixteen for deepseek's prefill, whose check judges
# sixteen batches of its shortest prompts
CELLS = {
    "jamba52b.decode-chat8": ("smoke-jamba", "decode-small", 1.0),
    "jamba52b.prefill-mix8k": ("smoke-jamba", "prefill-small", 0.02),
    "dsmoe16b.prefill-mix8k": ("smoke-deepseek", "prefill-small", 0.16),
}
TICK = 0.01
DECODE = [c for c in CELLS if ".decode" in c]
PREFILL = [c for c in CELLS if ".prefill" in c]


def load(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def smoke(cell: str) -> dict:
    cfg, mix, secs = CELLS[cell]
    return {"cfg": load(cfg), "mix": load(mix),
            "check": load("smoke-limits")[cell], "seconds": secs}


@contextlib.contextmanager
def fixed_clock():
    """The load generators' clock advances ``TICK`` seconds a reading, so that a
    window holds the same steps however fast the CPU is."""
    from portbench.kinds import closed_loop, prefill_batches
    now = [0.0]

    def tick():
        now[0] += TICK
        return now[0]
    fake = SimpleNamespace(perf_counter=tick)
    mods = (closed_loop, prefill_batches)
    saved = [m.time for m in mods]
    for m in mods:
        m.time = fake
    try:
        yield
    finally:
        for m, t in zip(mods, saved):
            m.time = t


def run(cell: str, seed: int = 1, trace: bool = False) -> tuple:
    s = smoke(cell)
    from portbench import core
    with fixed_clock():
        return core.run_cell(cell, seed, s["seconds"], trace,
                             torch.device("cpu"), time.perf_counter(),
                             cfg=s["cfg"], mix=s["mix"], check=s["check"])
