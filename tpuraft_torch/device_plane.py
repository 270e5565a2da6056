"""The device plane driven as the host runtime consumes it: G raft
groups' commit advancement, one fused tick a tick, with pipelined
dispatch and a bounded in-flight window.

The counterpart of the loop of the JAX package's ``bench.py``.  Per
tick: the followers' acks (a seeded int8 ``advances[tick]`` plane) are
added to the host's [G, P] match, the match goes up in one copy, the
fused tick (:func:`tpuraft_torch.ops.tick.raft_tick`) advances every
group on the state carried on the device from the tick before, and the
[G] commit row comes back in one asynchronous copy.  Tick i+1's upload
and launch do not wait for tick i's commit: acks are drained as they
arrive, and at most ``depth`` ticks stay outstanding.

The upload and the download go through a ring of pinned host slots,
each with a ``torch.cuda.Event`` recorded after its download: a slot
goes back to the ring only once its event has completed, so a later
tick never writes a host buffer that a copy still reads (a copy from
pageable memory would not be asynchronous at all).  Every copy and
launch is on the device's current stream, so stream order also protects
the blocks the caching allocator hands out again.

On a card the tick is the fused-tick kernel; on the CPU (only when the
caller passes ``device="cpu"``) it is the plain version.  No path moves
from one to the other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from tpuraft_torch.ops import tick as _tick
from tpuraft_torch.ops.tick import (ROLE_LEADER, GroupState, TickParams,
                                    raft_tick)

RTT_PROBES = 5      # single synchronised ticks: the completion RTT
BURST = 8           # ticks submitted back to back: the dispatch cost
PASSES = 3          # measurement passes; the median is reported
WARMUP_DEPTH = 16   # the window before the link is measured
MAX_DEPTH = 64


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a card that is not there is
    refused, never replaced by the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{dev} requested but no CUDA device is available; pass "
                f"device='cpu' to run the plain tick on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def leader_state(groups: int, peers: int, voters: int,
                 device) -> GroupState:
    """Every group a leader whose first ``voters`` peer slots vote, with
    ``pending_rel`` 1: the state of ``bench.py`` and of ``entry()``."""
    voter = torch.zeros((groups, peers), dtype=torch.bool, device=device)
    voter[:, :voters] = True
    return dataclasses.replace(
        GroupState.zeros(groups, peers, device),
        role=torch.full((groups,), ROLE_LEADER, dtype=torch.int32,
                        device=device),
        voter_mask=voter,
        pending_rel=torch.ones(groups, dtype=torch.int32, device=device))


def plane_advances(groups: int, peers: int, voters: int, batch: int,
                   n_ticks: int, seed: int) -> np.ndarray:
    """The acks of ``n_ticks`` ticks, int8 [n_ticks, G, P]: each voter
    acks ``batch // 2`` to ``batch`` entries a tick, other slots 0.  The
    draw of ``bench.py`` (a longer draw starts with the same ticks)."""
    rng = np.random.default_rng(seed)
    adv = rng.integers(batch // 2, batch + 1,
                       (n_ticks, groups, peers)).astype(np.int8)
    adv[:, :, voters:] = 0
    return adv


class _Slot:
    """One slot of the ring: the [G, P] match going up, the [G] commit
    coming back (both pinned on a card), and the event recorded after
    the download."""

    def __init__(self, g: int, p: int, dev: torch.device):
        cuda = dev.type == "cuda"
        self.match = torch.empty((g, p), dtype=torch.int32, pin_memory=cuda)
        self.match_np = self.match.numpy()
        self.match_dev = (torch.empty((g, p), dtype=torch.int32, device=dev)
                          if cuda else self.match)
        self.commit = torch.empty(g, dtype=torch.int32, pin_memory=cuda)
        self.commit_np = self.commit.numpy()
        self.done = torch.cuda.Event() if cuda else None

    def ready(self) -> bool:
        return self.done is None or self.done.query()

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()


def _device_busy(prof) -> tuple[float, int, int]:
    """(device busy us, kernels, copies) of a profiler window: the sum
    of the device events' own times (one stream: they do not overlap)."""
    busy = 0.0
    kernels = copies = 0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
        busy += e.self_device_time_total
    return busy, kernels, copies


def run_plane(groups: int = 16384, peers: int = 8, voters: int = 3,
              batch: int = 32, ticks: int = 400, warmup: int = 40,
              seed: int = 0, device="cuda", depth: int | None = None,
              record: bool = False) -> dict:
    """Drive the plane as ``bench.py`` does and report it.

    ``warmup`` ticks at a window of 16, then ``RTT_PROBES`` single
    synchronised ticks (the completion RTT), a burst of ``BURST`` ticks
    (the dispatch cost), and ``PASSES`` timed passes of ``(ticks -
    BURST) // PASSES`` ticks; the median pass by commits/s is reported.
    Then one more pass of as many ticks under ``torch.profiler``: its
    wall, the device's busy time and the kernels and copies it ran (its
    acks are drawn after the first ``warmup + ticks``, which stay
    bench.py's).  ``depth`` fixes the window throughout; None sizes it
    after the burst as ``max(4, min(64, rtt / dispatch + 4))``.
    ``record`` keeps every submitted tick's commit row (``rows``, [n, G]
    in tick order).
    """
    dev = resolve_device(device)
    half = (ticks - BURST) // PASSES
    if warmup < 1 or half < 1 or not 1 <= voters <= peers:
        raise ValueError(f"run_plane: warmup={warmup}, ticks={ticks} "
                         f"(at least {BURST + PASSES}), voters={voters} "
                         f"of {peers} peer slots")
    if depth is not None and not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"run_plane: depth {depth} not in 1..{MAX_DEPTH}")
    total = warmup + ticks + half
    advances = plane_advances(groups, peers, voters, batch, total, seed)
    cuda = dev.type == "cuda"
    with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
        return _Plane(groups, peers, voters, dev, advances, record).run(
            warmup, half, depth)


class _Plane:
    """The loop's state: the device state carried tick to tick, the host
    match, the ring and the window."""

    def __init__(self, g, p, voters, dev, advances, record):
        self.g, self.p, self.dev = g, p, dev
        self.cuda = dev.type == "cuda"
        self.advances = advances
        self.state = leader_state(g, p, voters, dev)
        self.params = TickParams.make(1000, 100, 900, device=dev)
        self.host_match = np.zeros((g, p), np.int32)
        self.slots: list[_Slot] = []
        self.free: deque[_Slot] = deque()
        self.inflight: deque = deque()  # (submit time, tick, slot)
        self.depth = WARMUP_DEPTH
        self.lat: list[float] = []
        self.last_commit = np.zeros(g, np.int32)
        self.rows: list[np.ndarray] | None = [] if record else None
        self.submitted = 0

    def _window(self, depth: int) -> None:
        """Set the window; the ring grows to it (only with nothing in
        flight)."""
        self.depth = depth
        while len(self.slots) < depth:
            s = _Slot(self.g, self.p, self.dev)
            self.slots.append(s)
            self.free.append(s)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.current_stream(self.dev).synchronize()

    def drain_one(self) -> None:
        ts, _, slot = self.inflight.popleft()
        slot.wait()
        self.last_commit = slot.commit_np.copy()  # the commit ack
        self.lat.append(time.perf_counter() - ts)
        if self.rows is not None:
            self.rows.append(self.last_commit)
        self.free.append(slot)

    def drain_all(self) -> None:
        while self.inflight:
            self.drain_one()

    def submit(self, i: int) -> None:
        np.add(self.host_match, self.advances[i], out=self.host_match)
        slot = self.free.popleft()  # drained: its event has completed
        np.copyto(slot.match_np, self.host_match)
        if self.cuda:
            slot.match_dev.copy_(slot.match, non_blocking=True)
        state = dataclasses.replace(self.state, match_rel=slot.match_dev)
        self.state, out = raft_tick(state, i, self.params)
        slot.commit.copy_(out.commit_rel, non_blocking=self.cuda)
        if self.cuda:
            slot.done.record()
        self.inflight.append((time.perf_counter(), i, slot))
        self.submitted += 1
        # drain acks as they arrive, then hold the window
        while self.inflight and self.inflight[0][2].ready():
            self.drain_one()
        while len(self.inflight) >= self.depth:
            self.drain_one()

    def timed_pass(self, start: int, n: int) -> dict:
        self.lat.clear()
        base = int(self.last_commit.sum())
        t0 = time.perf_counter()
        for i in range(start, start + n):
            self.submit(i)
        self.drain_all()
        elapsed = time.perf_counter() - t0
        commits = int(self.last_commit.sum()) - base
        lat_ms = sorted(x * 1000 for x in self.lat)
        return {"commits_per_sec": commits / elapsed,
                "ticks_per_sec": n / elapsed, "commits": commits,
                "ticks": n, "wall_s": elapsed,
                "ack_p50_ms": lat_ms[len(lat_ms) // 2],
                "ack_p99_ms": lat_ms[int(len(lat_ms) * 0.99)]}

    def run(self, warmup: int, half: int, depth) -> dict:
        launches0 = _tick.LAUNCHES
        self._window(depth or WARMUP_DEPTH)
        for i in range(warmup):
            self.submit(i)
        self.drain_all()

        # the completion RTT: the least dispatch-to-completion time of
        # one tick, whatever the window
        rtts = []
        for _ in range(RTT_PROBES):
            t1 = time.perf_counter()
            self.state, _ = raft_tick(self.state, 0, self.params)
            self._sync()
            rtts.append(time.perf_counter() - t1)

        # the dispatch cost: a short burst, not synchronised
        t_b = time.perf_counter()
        for i in range(warmup, warmup + BURST):
            self.submit(i)
        dispatch_s = (time.perf_counter() - t_b) / BURST
        self.drain_all()

        # the window sized to the link: enough ticks in flight to cover
        # the RTT at the dispatch cost, plus a margin
        self._window(depth or max(4, min(MAX_DEPTH, int(
            min(rtts) / max(dispatch_s, 1e-4)) + 4)))

        passes = []
        start = warmup + BURST
        for _ in range(PASSES):
            passes.append(self.timed_pass(start, half))
            start += half
        med = sorted(passes, key=lambda r: r["commits_per_sec"])[
            PASSES // 2]
        profiled = self.profiled_pass(start, half)
        res = {
            "groups": self.g, "peer_slots": self.p,
            "device": str(self.dev),
            "commits_per_sec": med["commits_per_sec"],
            "ticks_per_sec": med["ticks_per_sec"],
            "ack_p50_ms": med["ack_p50_ms"], "ack_p99_ms": med["ack_p99_ms"],
            "commits_per_tick_per_group": med["commits"] / med["ticks"]
            / self.g,
            "dispatch_ms": dispatch_s * 1000,
            "pipeline_depth": self.depth,
            "depth_sized_from_link": depth is None,
            "completion_rtt_ms": min(rtts) * 1000,
            "rtt_ms": [x * 1000 for x in rtts],
            "aggregation": "median_of_3_passes",
            "passes": passes,
            "profiled_pass": profiled,
            "total_commits": int(self.last_commit.sum()),
            "submitted": self.submitted,
            "ticks_run": self.submitted + RTT_PROBES,
            "launches": _tick.LAUNCHES - launches0,
        }
        if self.rows is not None:
            res["rows"] = np.stack(self.rows)
        return res

    def profiled_pass(self, start: int, n: int) -> dict:
        """One more pass under the profiler: the device's busy time over
        the pass's wall (the profiler's own host cost is in that wall)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            rec = self.timed_pass(start, n)
        if not self.cuda:
            return {**rec, "device_busy_ms": None, "busy_share": None}
        busy_us, kernels, copies = _device_busy(prof)
        return {**rec, "device_busy_ms": busy_us / 1e3,
                "busy_share": busy_us / 1e6 / rec["wall_s"],
                "device_busy_us_per_tick": busy_us / n,
                "kernels": kernels, "copies": copies}
