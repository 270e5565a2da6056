"""The per-layer metrics read from the program's span counters
(``benchmark/metrics/*_us_per_tick.plane.py``): a tiny traced run of
each plane cell on the CPU gives every one a number; with the counters
reset, each reads nothing."""

import pytest

from benchmark.core import spec as spec_mod
from benchmark.tests import tiny

SPAN_METRICS = ("acks_add_us_per_tick.plane", "pin_stage_us_per_tick.plane",
                "tick_call_us_per_tick.plane", "drain_wait_us_per_tick.plane")


@pytest.mark.parametrize("name", ["plane.g64k.uniform", "plane.g64k.zipf"])
def test_a_traced_run_reads_every_span_metric(name):
    from tpuraft_torch.ops import tick

    tick.reset_spans()
    try:
        out, ctx = tiny.run(tiny.cell(name), seconds=0.6, trace=True)
        assert out["correct"]
        # the counters cover the traced ticks, and no others
        assert tick.SPANS["plane.submit"][0] == ctx["trace"]["ticks"] > 0
        for m in SPAN_METRICS:
            value = out["metrics"][m]["value"]
            assert out["metrics"][m]["unit"] == "us"
            if m.startswith("drain_wait"):
                assert value >= 0, m
            else:
                assert value > 0, m
    finally:
        tick.reset_spans()


def test_with_the_counters_reset_no_span_metric_reads():
    from tpuraft_torch.ops import tick

    tick.reset_spans()
    for m in SPAN_METRICS:
        assert spec_mod.reader(m)({}) is None, m
