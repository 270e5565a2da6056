"""device_idle_share.plane: the share of the card's time in which no
operation ran on it, at the window's untraced pace (the traced part's
profiler device time a tick, times the untraced part's ticks a second;
``benchmark/core/devtrace.py`` ``paced_idle_share``)."""

from benchmark.core.devtrace import paced_idle_share


def read(ctx):
    return paced_idle_share(ctx)
