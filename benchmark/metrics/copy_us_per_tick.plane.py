"""copy_us_per_tick.plane: device time of the traced window's copies
(the profiler's ``Memcpy*`` events: the match up, the commit row down)
over the ticks submitted in the traced part of the window."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("ticks"):
        return None
    s = sum(sec for name, (_, sec) in tr["ops"].items()
            if name.startswith("Memcpy"))
    return s / tr["ticks"] * 1e6 if s > 0 else None
