"""Tiny versions of the cells, for the CPU."""

from __future__ import annotations

import copy
import time

from benchmark import run as run_mod
from benchmark.core import spec as spec_mod


def cell(name: str):
    """The cell, cut to a size the CPU runs in seconds."""
    c = spec_mod.resolve(spec_mod.load_spec(), name)
    c.config = copy.deepcopy(c.config)
    c.traffic = dict(c.traffic)
    c.config.update(groups=256, warmup_ticks=32, sample_stride=16,
                    trace_seconds=0.2)
    if c.traffic["kind"] == "zipf":
        c.traffic["appends_per_tick"] = 64
    return c


def run(c, seed: int = 7, seconds: float = 1.0, trace: bool = False):
    """A run of the cell on the CPU, as ``benchmark/run.py`` makes it
    but for the look for a card: (result object, context)."""
    ctx = spec_mod.runner(c.config).run(c.config, c.traffic, seed, seconds,
                                        trace, "cpu", time.perf_counter())
    ctx["card"] = {"platform": "gpu", "kind": "cpu", "count": 1}
    out, _ = run_mod.result_line(c, ctx, ctx["card"], trace)
    return out, ctx
