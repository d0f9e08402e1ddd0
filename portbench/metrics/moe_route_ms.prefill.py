"""Device milliseconds under the program's ``moe.dispatch`` and
``moe.combine`` spans (router, top-k, sort, rank and the indexed copy in;
the gather and ordered sum out) per 1000 prompt tokens of stretch B.
Nothing where the program opens no such span or the trace holds no device
time."""


def read(ctx):
    b = getattr(ctx, "stretch_b", None) or {}
    span_s = b.get("span_s", {})
    ms = 1e3 * sum(span_s.get(k, 0.0) for k in ("moe.dispatch", "moe.combine"))
    if ms <= 0 or not b.get("tokens"):
        return None
    return ms / (b["tokens"] / 1000.0)
