"""acks_add_us_per_tick.plane: host microseconds a tick spent adding the
tick's acks into the host's [G, P] match (the span ``plane.acks_add``),
over the ticks submitted (``plane.submit``).

Read from the program's span counters (``tpuraft_torch/ops/tick.py``
``SPANS``), which count only while a torch profiler records: in a run of
``benchmark/run.py`` that is the traced part of the window (set-up's
throwaway profile runs no tick), so they cover the ticks the device
trace covers.  None where no tick was counted, or where the program
keeps no such counters."""


def read(ctx):
    from tpuraft_torch.ops import tick

    spans = getattr(tick, "SPANS", None)
    submits = spans.get("plane.submit", (0,))[0] if spans else 0
    if not submits:
        return None
    return spans.get("plane.acks_add", (0, 0))[1] / submits / 1e3
