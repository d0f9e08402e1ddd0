"""Device milliseconds of the kernels launched under
``models.layers.mamba_layer`` per 1000 prompt tokens of the traced stretch."""


def read(ctx):
    s = ctx.stretch
    ms = s["range_s"].get("mamba_layer", 0.0) * 1e3
    if ms <= 0 or not s.get("tokens"):
        return None
    return ms / (s["tokens"] / 1000.0)
