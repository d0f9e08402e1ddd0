"""Device milliseconds under the program's ``mamba.ssm`` span (dA and dBx
built, the scan, the y-contraction: what a fused selective-scan kernel
would replace) per 1000 prompt tokens of stretch B.  Nothing where the
program opens no such span or the trace holds no device time."""


def read(ctx):
    b = getattr(ctx, "stretch_b", None) or {}
    ms = b.get("span_s", {}).get("mamba.ssm", 0.0) * 1e3
    if ms <= 0 or not b.get("tokens"):
        return None
    return ms / (b["tokens"] / 1000.0)
