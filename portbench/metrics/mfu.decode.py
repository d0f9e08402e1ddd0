"""Model FLOPs of the window's tokens (every occupied slot-step; empty slots
do not count) over the window's seconds, as a share of the card's dense
bf16 peak (``roofline.model_flops``, ``roofline.PEAK_FLOPS_BF16``)."""
from portbench import roofline


def read(ctx):
    w = ctx.window
    if not w.get("window_s"):
        return None
    return 100.0 * w["model_flops"] / w["window_s"] / roofline.PEAK_FLOPS_BF16
