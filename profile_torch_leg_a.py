#!/usr/bin/env python3
"""Where leg A's engine tick spends its time, on one CUDA card.

    python3 profile_torch_leg_a.py [--cpu] [--out FILE]

Runs ``chip_smoke.py``'s leg A (3 stores x 1,024 regions, the KV store)
up to the end of its YCSB-A mix and stops there.  Over the mix's first
half the engine's ``_device_tick`` is timed part by part on the host
clock (fill, upload, launch, fetch, the stream wait with the views in
between, landed); over the second half ``torch.profiler`` traces the
card's activity only (its kernels and copies, its busy share of the
window), which keeps the profiler's own host work small.

Prints one JSON line and writes it to ``--out`` (default
``chiprun_out/profile_leg_a.json``), also after the first half, should
the second fail.  Needs a card; ``--cpu`` rehearses the leg at 16
regions on the CPU (no device number).  Put ``rm -f
tpuraft_torch/native/*.so`` before it in a command run on a copied
tree, so that the native engines are built on the machine that loads
them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"


class _Parts:
    """Host seconds of each part of ``_device_tick``, over every engine."""

    NAMES = ("fill", "upload", "launch", "fetch", "landed")

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self):
        self.sums = {k: [] for k in (*self.NAMES, "total")}

    def wrap(self, obj, attr, key):
        orig = getattr(obj, attr)
        parts = self

        def timed(*a, **kw):
            if not parts.on:
                return orig(*a, **kw)
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                parts.sums[key].append(time.perf_counter() - t0)

        setattr(obj, attr, timed)

    def summary(self) -> dict:
        out = {}
        n = len(self.sums["total"])
        for k, xs in self.sums.items():
            a = np.asarray(xs) * 1e3
            out[k] = {"calls": len(xs), "ms_p50": float(np.percentile(a, 50))
                      if len(a) else None,
                      "ms_p99": float(np.percentile(a, 99)) if len(a)
                      else None, "ms_mean": float(a.mean()) if len(a)
                      else None, "ms_sum": float(a.sum())}
        if n:
            rest = (np.asarray(self.sums["total"]) - sum(
                np.asarray(self.sums[k]) for k in self.NAMES)) * 1e3
            out["wait_and_views"] = {
                "ms_p50": float(np.percentile(rest, 50)),
                "ms_p99": float(np.percentile(rest, 99)),
                "ms_mean": float(rest.mean()), "ms_sum": float(rest.sum())}
        return out


class _MixDone(Exception):
    pass


def device_busy(prof, wall_s: float) -> dict:
    """The card's kernels and copies in the profiled window: their
    device time, their count, the busy share of the window (intervals
    merged, so overlap counts once)."""
    spans, kinds = [], {}
    for ev in prof.events():
        dt = getattr(ev, "device_type", None)
        if dt is None or "CUDA" not in str(dt):
            continue
        start = ev.time_range.start
        end = ev.time_range.end
        spans.append((start, end))
        k = kinds.setdefault(ev.name, [0, 0.0])
        k[0] += 1
        k[1] += (end - start) / 1e3
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(kinds.items(), key=lambda kv: -kv[1][1])[:12]
    return {"window_s": wall_s, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / wall_s if wall_s else None,
            "device_events": len(spans),
            "by_name": {k: {"count": c, "ms": ms} for k, (c, ms) in top}}


def leg_a(args, write) -> dict:
    import asyncio
    import shutil
    import tempfile

    import torch

    import chip_smoke
    from tpuraft_torch.core import engine as tengine
    from tpuraft_torch.ops import quorum_cuda, tick
    from tpuraft_torch.parallel import mesh as pmesh

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("profile_torch_leg_a: no CUDA device")
    res = {"card": "cpu rehearsal" if args.cpu else card_line(),
           "torch": torch.__version__}
    if not args.cpu:
        quorum_cuda.load()
    chip_smoke.phase_native()
    parts = _Parts()
    for name in ("fill", "upload", "fetch", "landed"):
        parts.wrap(tengine._TickStaging, name, name)
    parts.wrap(pmesh, "raft_tick_outputs", "launch")
    parts.wrap(tengine.MultiRaftEngine, "_device_tick", "total")
    orig_ops = chip_smoke.run_kv_ops
    calls = {"n": 0}

    async def ops(kv, hist, todo, lats=None):
        calls["n"] += 1
        if calls["n"] != 2:  # the load; the mix is the second call
            return await orig_ops(kv, hist, todo, lats)
        engines = list(fabs[-1].engines)
        half = len(todo) // 2
        parts.reset()
        parts.on = True
        ticks0 = sum(e.ticks for e in engines)
        t0 = time.perf_counter()
        await orig_ops(kv, hist, todo[:half], lats)
        res["host_window_s"] = time.perf_counter() - t0
        res["host_window_ticks"] = sum(e.ticks for e in engines) - ticks0
        res["host_parts"] = parts.summary()
        res["tick_histograms_at_half"] = [e.tick_histograms()
                                          for e in engines]
        write(res)  # kept should the profiled half fail
        parts.on = False
        # the card's activity only (on the CPU rehearsal, its host ops)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU if args.cpu
            else torch.profiler.ProfilerActivity.CUDA])
        ticks0 = sum(e.ticks for e in engines)
        launches0 = tick.LAUNCHES
        prof.start()
        t0 = time.perf_counter()
        try:
            await orig_ops(kv, hist, todo[half:], lats)
        except AssertionError as e:  # the profile stands; the leg is cut
            res["profiled_half_errors"] = str(e)[:2000]
        if not args.cpu:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.stop()
        res["profiled_ticks"] = sum(e.ticks for e in engines) - ticks0
        res["profiled_launches"] = tick.LAUNCHES - launches0
        res["profile"] = device_busy(prof, wall)
        # boot to the mix's end: the engines' own histograms
        res["tick_histograms"] = [e.tick_histograms() for e in engines]
        raise _MixDone

    fabs = []
    orig_fab = chip_smoke.KVFabric

    class Fab(orig_fab):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fabs.append(self)

    chip_smoke.run_kv_ops = ops
    chip_smoke.KVFabric = Fab
    cargs = argparse.Namespace(cpu=args.cpu, groups=16 if args.cpu else None,
                         quick=False)
    data = tempfile.mkdtemp(prefix="tpuraft_profile_kv_")
    try:
        asyncio.run(chip_smoke.kv_leg_store(cargs, quorum_cuda, tick,
                                            f"{data}/a"))
    except _MixDone:
        pass
    finally:
        shutil.rmtree(data, ignore_errors=True)
    res["card_after"] = "cpu rehearsal" if args.cpu else card_line()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse at 16 regions on the CPU (no device "
                    "number)")
    ap.add_argument("--out")
    args = ap.parse_args()
    out = Path(args.out or ROOT / "chiprun_out" / "profile_leg_a.json")
    out.parent.mkdir(parents=True, exist_ok=True)

    def write(res):
        out.write_text(json.dumps(res, indent=1))

    res = leg_a(args, write)
    write(res)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
