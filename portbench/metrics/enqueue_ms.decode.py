"""Host milliseconds a decode step spends in the program's ``engine.forward``
span (the host enqueueing ``lm.decode_step``) in stretch S: tracing on, no
profiler.  Nothing where the program opens no such span."""


def read(ctx):
    s = getattr(ctx, "stretch_s", None) or {}
    f = s.get("spans", {}).get("engine.forward")
    if not f or not f["count"]:
        return None
    return 1e3 * f["total_s"] / f["count"]
