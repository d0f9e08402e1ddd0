"""Share of the traced stretch's wall time in which no operation ran on the
device: 1 - busy / wall, busy the union of the kernels' intervals."""


def read(ctx):
    s = ctx.stretch
    if s["busy_s"] <= 0 or not s.get("wall_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
