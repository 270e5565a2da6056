"""The commit-plane cells: G raft groups' commit advancement through
``tpuraft_torch.device_plane``'s pipelined loop (``_Plane.submit``): per
tick the followers' acks land in the host's [G, P] match, one H2D copy,
one ``raft_tick`` (the fused-tick kernel), one asynchronous D2H of the
commit row, at most ``depth`` ticks in flight.

The acks stream from a seeded ring (``benchmark/core/acks.py``).  Set-up
loads the kernel library (built on a checkout's first run), draws the
ring and runs ``warmup_ticks`` ticks at the cell's own G and P.  The
window submits ticks until ``seconds`` have passed, then drains them; a
traced run profiles the window's last ``trace_seconds``.
The commit rows of ticks sampled from the seed, and of the last tick,
are kept; once the window has closed and the plane is freed, the
reference (``benchmark/reference/commit_row.py``) recomputes them.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core import acks as acks_mod
from benchmark.core import devtrace
from benchmark.reference import commit_row

HOST_LABELS = ("host.submit", "host.drain")
MIN_UNTRACED_S = 1.0  # the least untraced time a pace is read from


def sampled(seed: int, stride: int):
    """Whether tick i's row is kept: one tick in ``stride``, at an
    offset drawn from the seed."""
    off = int(np.random.default_rng(seed).integers(0, stride))
    return lambda i: i % stride == off


def make_plane(cfg: dict, dev, advances, keep, labels: bool):
    """The program's loop, with the harness's view of it: the rows of
    kept ticks, and (``labels``) the host's ranges for the trace."""
    import torch

    from tpuraft_torch.device_plane import _Plane

    class HarnessPlane(_Plane):
        def drain_one(self) -> None:
            i = self.inflight[0][1]
            if labels:
                with torch.profiler.record_function("host.drain"):
                    super().drain_one()
            else:
                super().drain_one()
            if keep(i):
                self.kept[i] = self.last_commit  # a fresh copy a drain

        def submit(self, i: int) -> None:
            if labels:
                with torch.profiler.record_function("host.submit"):
                    super().submit(i)
            else:
                super().submit(i)

    plane = HarnessPlane(int(cfg["groups"]), int(cfg["peer_slots"]),
                         int(cfg["voters"]), dev, advances, False)
    plane.kept = {}
    plane._window(int(cfg["depth"]))
    return plane


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float) -> dict:
    import contextlib

    import torch

    from tpuraft_torch.device_plane import resolve_device
    from tpuraft_torch.ops import tick as _tick

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        from tpuraft_torch.ops import quorum_cuda

        quorum_cuda.load()
    g, p, v = (int(config["groups"]), int(config["peer_slots"]),
               int(config["voters"]))
    ring = acks_mod.make_ring(traffic, g, p, v, int(config["ring_ticks"]),
                              seed)
    keep = sampled(seed, int(config["sample_stride"]))
    with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
        plane = make_plane(config, dev, acks_mod.RingView(ring), keep,
                           trace)
        warm = int(config["warmup_ticks"])
        for i in range(warm):
            plane.submit(i)
        plane.drain_all()
        base = int(plane.last_commit.sum(dtype=np.int64))
        plane.lat.clear()
        launches0 = _tick.LAUNCHES
        # the traced run profiles the window's last trace_seconds
        tracer = devtrace.WindowTracer(dev.type) if trace else None
        trace_from = (seconds - float(config.get("trace_seconds", seconds))
                      if trace else float("inf"))
        i_trace = None
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        i = warm
        while True:
            plane.submit(i)
            i += 1
            now = time.perf_counter() - t0
            if i_trace is None and now >= trace_from:
                tracer.start()
                i_trace, t_trace = i, now
            if now >= seconds:
                break
        plane.drain_all()
        window_s = time.perf_counter() - t0
        traced_s = tracer.stop() if tracer is not None else 0.0
        last = i - 1
        plane.kept[last] = plane.last_commit
        committed = int(plane.last_commit.sum(dtype=np.int64)) - base
        ticks = i - warm
        launches = _tick.LAUNCHES - launches0
        lat = list(plane.lat)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        summary = pace = None
        if tracer is not None:
            summary = devtrace.summarize(tracer.prof, traced_s, HOST_LABELS)
            summary["ticks"] = i - i_trace
            if t_trace >= MIN_UNTRACED_S:
                pace = {"untraced_per_s": (i_trace - warm) / t_trace,
                        "traced_per_s": (i - i_trace) / traced_s}
        rows = plane.kept
        del plane, tracer
        if cuda:
            torch.cuda.empty_cache()

    # the reference recomputes the kept rows
    t_ref = time.perf_counter()
    verdict = commit_row.check(rows, ring, v)
    expect = sum(1 for t in range(warm, last + 1) if keep(t)) + (
        0 if keep(last) else 1)
    verdict["rows_missing"] = expect - sum(1 for t in rows if t >= warm)
    ref_s = time.perf_counter() - t_ref
    return {
        "setup_s": setup_s,
        "window_s": window_s,
        "attempted": ticks,
        "failed": 0,
        "committed": committed,
        "ticks": ticks,
        "launches": launches,
        "lat_s": lat,
        "groups": g,
        "peer_slots": p,
        "memory_peak_bytes": peak,
        "trace": summary,
        "pace": pace,
        "checks": {k: (verdict[k], commit_row.LIMITS[k])
                   for k in commit_row.LIMITS},
        "notes": {"rows_compared": verdict["rows_compared"],
                  "launches": launches, "ticks": ticks,
                  "reference_s": ref_s, "ticks_per_s": pace},
    }
