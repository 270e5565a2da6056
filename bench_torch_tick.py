#!/usr/bin/env python3
"""Micro-measurements of the port's device tick on one CUDA card.

    python3 bench_torch_tick.py [--out FILE]

Two parts, each printed as one JSON line (and written together to
``--out``, default ``chiprun_out/bench_torch_tick.json``):

1. ``kernels``: device time per launch of the fused-quorum kernel and of
   the fused tick at the cluster's G=1,028 and the engine plane's
   G=16,384 (P=8) and at G=16,421 (P=16), each checked equal to its plain
   version first.  Device time per launch comes from a CUDA graph of 100
   launches, replayed; 4 timings per kernel and shape.
2. ``tick``: ``MultiRaftEngine.tick_once`` on the card at G=1,028 and
   G=16,384 (3 voters, acks between ticks): the host's wall time per
   tick over 50 ticks, then 50 more under ``torch.profiler``: CUDA
   kernels and copies per tick, their device time per tick (device idle
   share = 1 - device busy / unprofiled wall), the device-timeline span
   of the engine's ``tpuraft.raft_tick`` range, and the heaviest device
   and host events.

To compare two trees on one card, run each tree's copy of this script in
one call, in turns (parent, change, change, parent), each with its own
``--out``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from chip_smoke import SEED, quorum_inputs, rand_tick_fields, time_graph

SHAPES = ((1028, 8), (16384, 8), (16384 + 37, 16))


def part_kernels(torch, quorum_cuda, tick) -> list[dict]:
    rng = np.random.default_rng(SEED)
    rows = []
    for g, p in SHAPES:
        case = [torch.from_numpy(a).cuda() for a in quorum_inputs(rng, g, p)]
        for a, b in zip(quorum_cuda.fused_quorum(*case),
                        quorum_cuda.fused_quorum_reference(*case)):
            if not torch.equal(a, b):
                raise AssertionError(f"fused_quorum differs from plain "
                                     f"at G={g} P={p}")
        state = tick.group_state_from_numpy(rand_tick_fields(rng, g, p),
                                            device="cuda")
        params = tick.tick_params_from_numpy(
            rng.integers(300, 1200, g), rng.integers(50, 200, g),
            rng.integers(200, 1000, g), rng.integers(0, 2, g) * 700,
            device="cuda")
        now = int(rng.integers(0, 3000))
        buf = torch.empty(tick.packed_nbytes(g), dtype=torch.uint8,
                          device="cuda")
        got = tick.raft_tick_outputs(state, now, params, out=buf)
        want = tick.raft_tick_reference(state, now, params)[1]
        for f in dataclasses.fields(want):
            if not torch.equal(getattr(got, f.name), getattr(want, f.name)):
                raise AssertionError(f"fused tick {f.name} differs from "
                                     f"plain at G={g} P={p}")
        quorum_ms, tick_ms = [], []
        for _ in range(4):
            quorum_ms.append(time_graph(
                torch, lambda: quorum_cuda.fused_quorum(*case)))
            tick_ms.append(time_graph(
                torch, lambda: tick.raft_tick_outputs(state, now, params,
                                                      out=buf)))
        rows.append({"G": g, "P": p, "fused_quorum_ms": quorum_ms,
                     "fused_tick_ms": tick_ms})
    return rows


def _device_events(prof, torch, ticks):
    """(kernels, copies, device busy us, device span us of the engine's
    ``tpuraft.raft_tick`` range, the heaviest device events per tick, the
    heaviest host events per tick by their own host time) from the
    profiler's events.  A ``record_function`` range shows
    on the device timeline too, spanning its kernels and the gaps
    between them: it is the span, not busy time."""
    kernels = copies = 0
    busy_us = span_us = 0.0
    per, host = [], []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append({"name": e.key[:90], "per_tick": e.count / ticks,
                         "host_us_per_tick": e.self_cpu_time_total / ticks})
            continue
        if getattr(e, "is_user_annotation", False) \
                or e.key.startswith("tpuraft."):
            span_us += e.device_time_total
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
        busy_us += e.self_device_time_total
        per.append({"name": e.key[:90], "per_tick": e.count / ticks,
                    "us_per_tick": e.self_device_time_total / ticks})
    per.sort(key=lambda r: -r["us_per_tick"])
    host.sort(key=lambda r: -r["host_us_per_tick"])
    return kernels, copies, busy_us, span_us, per[:10], host[:10]


async def _tick_profile(torch, g, ticks=50) -> dict:
    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.entity import PeerId
    from tpuraft_torch.ops import tick
    from tpuraft_torch.options import TickOptions

    peers = [PeerId.parse(f"127.0.0.1:{7500 + i}") for i in range(3)]
    conf = Configuration(peers)
    eng = MultiRaftEngine(TickOptions(max_groups=g, max_peers=8,
                                      eager_commit=False))
    await eng.start()
    try:
        factory = eng.ballot_box_factory()
        boxes = []
        for _ in range(g):
            box = factory(lambda idx: None)
            box.update_conf(conf, Configuration())
            box.reset_pending_index(1)
            boxes.append(box)
        rng = np.random.default_rng(SEED + g)
        idx = 1

        def acks():
            nonlocal idx
            idx += 1
            for box in boxes:
                for p in peers:
                    if rng.random() < 0.8:
                        box.commit_at(p, idx, conf, Configuration())

        for _ in range(5):  # warm
            acks()
            eng.tick_once()
        torch.cuda.synchronize()

        def run(n):
            wall = 0.0
            for _ in range(n):
                acks()
                t0 = time.perf_counter()
                eng.tick_once()
                wall += time.perf_counter() - t0
            return wall / n * 1e3

        launches = tick.LAUNCHES
        wall_ms = run(ticks)  # the profiler's own overhead left out
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            prof_wall_ms = run(ticks)
            torch.cuda.synchronize()
        launches = (tick.LAUNCHES - launches) / (2 * ticks)
        kernels, copies, busy_us, span_us, top, host = _device_events(
            prof, torch, ticks)
        hist = eng.tick_histograms()["tick_device_ms"]
    finally:
        await eng.shutdown()
    busy_ms = busy_us / ticks / 1e3
    return {"G": g, "ticks": ticks,
            "fused_tick_launches_per_tick": launches,
            "kernels_per_tick": kernels / ticks,
            "copies_per_tick": copies / ticks,
            "device_busy_ms_per_tick": busy_ms,
            "raft_tick_device_span_ms": span_us / ticks / 1e3,
            "tick_once_wall_ms": wall_ms,
            "tick_once_wall_ms_profiled": prof_wall_ms,
            "tick_device_ms_p50": hist["p50"],
            "tick_device_ms_p99": hist["p99"],
            "device_idle_share_in_tick": (1 - busy_ms / wall_ms
                                          if busy_us else None),
            "heaviest": top, "host_heaviest": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "bench_torch_tick.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_tick: no CUDA device", file=sys.stderr)
        return 2
    from tpuraft_torch.ops import quorum_cuda, tick

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    quorum_cuda.load()
    res = {"card": card, "source_sha": quorum_cuda._library_path().stem}
    res["kernels"] = part_kernels(torch, quorum_cuda, tick)
    print(json.dumps({"kernels": res["kernels"]}), flush=True)
    res["tick"] = [asyncio.run(_tick_profile(torch, g))
                   for g in (1028, 16384)]
    print(json.dumps({"tick": res["tick"]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
