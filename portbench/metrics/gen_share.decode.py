"""Share of the window's slot-steps that produced a generated token (the
rest fed a prompt token, since the engine feeds prompts one token a step,
or stepped an empty slot): a count of the engine's work."""


def read(ctx):
    w = ctx.window
    if not w.get("slot_steps"):
        return None
    return 100.0 * w["generated"] / w["slot_steps"]
