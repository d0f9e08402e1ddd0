"""Device milliseconds per engine step of the kernels launched under
``models.layers.moe_ffn`` in the traced stretch."""


def read(ctx):
    s = ctx.stretch
    ms = s["range_s"].get("moe_ffn", 0.0) * 1e3
    if ms <= 0 or not s.get("steps"):
        return None
    return ms / s["steps"]
