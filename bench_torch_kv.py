#!/usr/bin/env python3
"""Where the time of the port's KV store goes, on one CUDA card.

    python3 bench_torch_kv.py [--regions 1024] [--snapshot-secs 10]
                              [--profile] [--out FILE] [--cpu]

Boots chip_smoke.py's in-process fabric (3 durable StoreEngines, one
MultiRaftEngine each, sized by the server's rule, every store's regions
on one multilog journal and its data on the native KV engine, built
first from tpuraft_torch/native), elects, loads 16
1,000-byte records per region and runs YCSB-A over them (16 operations
per region, 50/50 read/update, zipfian 0.99, 64 workers), as phase 6
leg A does up to its failover.  Over the mix it records the ops/s, the
acknowledgement latency, the snapshots the tick's snap_due lane took,
the engines' tick histograms, and the CPU time of the event loop's
thread against that of the whole process (the difference is other
threads: log flushes, snapshot commits, the disk reconcile).  With
--profile it runs cProfile on the event loop's thread over the mix and
lists the heaviest functions by own time and by cumulative time.
``--snapshot-secs 0`` turns periodic snapshots off.  One JSON line is
printed and written to --out (default chiprun_out/bench_torch_kv.json).
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs


def top(stats: pstats.Stats, key: str, n: int = 25) -> list[dict]:
    rows = []
    for (file, line, fn), (cc, nc, tt, ct, _) in stats.stats.items():
        rows.append({"fn": f"{os.path.basename(file)}:{line}:{fn}",
                     "calls": nc, "tottime_s": tt, "cumtime_s": ct})
    rows.sort(key=lambda r: -r[key])
    return rows[:n]


async def run(args) -> dict:
    from tpuraft_torch.util.linearizability import History

    n = args.regions
    n_keys = n * cs.KV_KEYS_PER_REGION
    rng = np.random.default_rng(cs.SEED + 11)
    value = cs.KVValues(rng)
    keys = [cs.kv_key(i, n_keys) for i in range(n_keys)]
    data = tempfile.mkdtemp(prefix="tpuraft_torch_kv_bench_")
    cs.phase_native()
    fab = cs.KVFabric(args, n, data, native=True, eto_ms=cs.DENSITY_ETO_MS,
                      snapshot_interval_secs=args.snapshot_secs)
    snaps, restore = cs.snap_due_counter()
    res = {"regions": n, "keys": n_keys,
           "snapshot_interval_secs": args.snapshot_secs}
    kv = None
    try:
        t0 = time.perf_counter()
        await fab.start_all()
        res["boot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        await fab.wait_leaders(120)
        res["elect_s"] = time.perf_counter() - t0
        kv = fab.client()
        await kv.start()
        hist = History()
        t0 = time.perf_counter()
        await cs.run_kv_ops(kv, hist, [("w", k, value(i))
                                       for i, k in enumerate(keys)])
        res["load_s"] = time.perf_counter() - t0
        op = n_keys
        mix = []
        for i, r in zip(cs.zipf_keys(rng, n_keys, n_keys),
                        rng.random(n_keys)):
            mix.append(("r", keys[i], None) if r < 0.5
                       else ("w", keys[i], value(op)))
            op += 1
        taken0 = snaps["taken"]
        ticks0 = sum(e.ticks for e in fab.engines)
        lats = []
        prof = cProfile.Profile() if args.profile else None
        cpu0, proc0 = time.thread_time(), time.process_time()
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        await cs.run_kv_ops(kv, hist, mix, lats)
        if prof is not None:
            prof.disable()
        wall = time.perf_counter() - t0
        res.update({
            "mix_s": wall, "mix_ops_per_s": len(mix) / wall,
            "mix_ack_ms_p50": cs.pct(lats, 50),
            "mix_ack_ms_p99": cs.pct(lats, 99),
            "loop_thread_cpu_share": (time.thread_time() - cpu0) / wall,
            "process_cpu_per_wall": (time.process_time() - proc0) / wall,
            "snapshots_in_mix": snaps["taken"] - taken0,
            "engine_ticks_in_mix": sum(e.ticks for e in fab.engines) - ticks0,
            "profiled": prof is not None})
        res.update(cs.tick_hist(fab.engines))
        if prof is not None:
            st = pstats.Stats(prof)
            res["top_tottime"] = top(st, "tottime_s")
            res["top_cumtime"] = top(st, "cumtime_s")
    finally:
        if kv is not None:
            await kv.shutdown()
        await fab.stop_all()
        restore()
        shutil.rmtree(data, ignore_errors=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--regions", type=int, default=1024)
    ap.add_argument("--snapshot-secs", type=int, default=cs.KV_SNAPSHOT_SECS)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="engines tick on the CPU (a rehearsal: no device "
                         "number)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "bench_torch_kv.json"))
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("bench_torch_kv: no CUDA device", file=sys.stderr)
        return 2
    res = asyncio.run(run(args))
    if not args.cpu:
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    res["device"] = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
