"""Share of the flash-attention launches' roofline in the traced stretch:
the sum over the launches of the least time their bytes and operations
take (``roofline.flash_bound_s``) over the summed device time of the flash
kernels.  Nothing where the trace holds no flash kernel or not one per
recorded call."""


def read(ctx):
    s = ctx.stretch
    if s["flash_s"] <= 0 or s["flash_kernels"] != s["flash_calls"]:
        return None
    return 100.0 * s["flash_bound_s"] / s["flash_s"]
