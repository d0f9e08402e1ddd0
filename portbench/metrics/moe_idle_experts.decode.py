"""Share of the experts the MoE layers read in stretch S that kept no pick:
100 x (1 - ``moe.experts_used`` / ``moe.experts_read``), the program's
counters (the expert products read every expert; an expert is used where
its entry of rank 0 is kept).  Nothing where the program counts neither."""


def read(ctx):
    c = (getattr(ctx, "stretch_s", None) or {}).get("counters", {})
    read_ = c.get("counter.moe.experts_read")
    used = c.get("device_counter.moe.experts_used")
    if not read_ or used is None:
        return None
    return 100.0 * (1.0 - used / read_)
