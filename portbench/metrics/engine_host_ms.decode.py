"""Host milliseconds a decode step spends in the program's ``engine.step``
span outside ``engine.forward`` and ``engine.sync`` in stretch S: the token
batch built and copied, the bookkeeping and admission.  Nothing where the
program opens no such span."""


def read(ctx):
    sp = (getattr(ctx, "stretch_s", None) or {}).get("spans", {})
    step = sp.get("engine.step")
    if not step or not step["count"]:
        return None
    inside = sum(sp.get(k, {}).get("total_s", 0.0)
                 for k in ("engine.forward", "engine.sync"))
    return 1e3 * (step["total_s"] - inside) / step["count"]
