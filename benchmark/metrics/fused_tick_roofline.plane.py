"""fused_tick_roofline.plane: the least time of one fused tick (its
bytes at the card's peak memory rate, ``benchmark/core/roofline.py``)
over the profiler's mean device time of a fused-tick launch, in %."""

from benchmark.core import roofline
from benchmark.core.devtrace import FUSED_TICK_KERNEL


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    n = sec = 0
    for name, (count, s) in tr["ops"].items():
        if FUSED_TICK_KERNEL in name:
            n += count
            sec += s
    if n == 0 or sec <= 0:
        return None
    least = roofline.least_seconds(
        roofline.fused_tick_bytes(ctx["groups"], ctx["peer_slots"]),
        ctx["card"]["kind"])
    return 100.0 * least / (sec / n)
