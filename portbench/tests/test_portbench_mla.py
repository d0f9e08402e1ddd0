"""DeepSeek-V2's configuration in a decode cell's harness at a smoke size
on the CPU: the closed loop, the trace and the output check run through
the absorbed MLA decode path."""
import time

import torch

from portbench import core
from portbench.tests.helpers import fixed_clock, load

# a decode cell of the benchmark, run with the smoke config and traffic
CELL = "jamba52b.decode-chat8"


def test_the_smoke_twin_decodes_through_the_absorbed_path():
    """The decode harness (closed loop, trace, output check) at the smoke
    size: correct, and every MLA decode call absorbed."""
    from repro_torch.obs import metrics, spans
    metrics.reset()
    mix = load("decode-small")
    limits = load("smoke-limits")["mla.decode-small"]
    with spans.profiled(), fixed_clock():
        line, _ = core.run_cell(CELL, 1, 1.0, True, torch.device("cpu"),
                                time.perf_counter(),
                                cfg=load("smoke-deepseek-v2"), mix=mix,
                                check=limits)
    counts = metrics.REGISTRY.collect()["counters"]
    metrics.reset()
    assert line["correct"], line["checks"]
    assert counts.get("mla.decode_absorbed", 0) > 0
    assert counts.get("mla.decode_recompute", 0) == 0
    assert counts["mla.latent_rows"] > 0
