#!/usr/bin/env python3
"""Gray-failure A/B on the port: a sustained slow-disk leader at region
density, with health detection and evacuation on against off.  The
counterpart of ``bench_gray.py``, a host-plane A/B (no engine).

One store's disk turns slow (every fsync pays hundreds of ms) while the
store stays alive; at 128 regions it leads about a third of the
keyspace.  With the gray-failure plane on
(``StoreEngineOptions.health_scoring`` + ``evacuate_on_sick``) the
store's HealthTracker scores it SICK off its own flush timing and
evacuates its leases at a bounded rate, so put p99 should come back
toward the healthy baseline while the fault still holds; with it off,
p99 stays high for the whole fault.

    python3 bench_torch_gray.py [--regions 128] [--workers 32] [--json]

Writes ``--out`` (default ``chiprun_out/bench_torch_gray.json``), never
a file in the working directory: healthy, faulted and recovered p99 of
each arm and their ratios, with ``device: null`` and the card's name
and power limit beside them.  Exits non-zero when an arm ran no op.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import sys
import time

from tpuraft_torch.rheakv.client import BatchingOptions, RheaKVStore
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions
from tpuraft_torch.rpc.transport import (InProcNetwork, InProcTransport,
                                         RpcServer)
from tpuraft_torch.storage.fault import ChaosDir

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench_torch_gray.json")


def _p(vals: list[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * len(s)))]


class _Cluster:
    def __init__(self, n_stores: int, n_regions: int, data_path: str,
                 detection: bool):
        self.net = InProcNetwork()
        self.endpoints = [f"127.0.0.1:{6400 + i}" for i in range(n_stores)]

        def bkey(k):
            return b"g%06d" % k

        self.regions = [
            Region(id=k + 1, start_key=bkey(k) if k else b"",
                   end_key=bkey(k + 1) if k + 1 < n_regions else b"",
                   peers=list(self.endpoints))
            for k in range(n_regions)]
        self.data_path = data_path
        self.detection = detection
        self.stores: dict[str, StoreEngine] = {}

    async def start(self) -> None:
        for ep in self.endpoints:
            server = RpcServer(ep)
            self.net.bind(server)
            self.net.start_endpoint(ep)
            opts = StoreEngineOptions(
                server_id=ep,
                initial_regions=[r.copy() for r in self.regions],
                data_path=self.data_path,
                election_timeout_ms=1000,
                health_scoring=self.detection,
                # detect fast against the measurement windows
                health_eval_interval_ms=250,
                evacuation_rate=8,
            )
            store = StoreEngine(opts, server,
                                InProcTransport(self.net, ep))
            await store.start()
            self.stores[ep] = store

    async def stop(self) -> None:
        for ep, store in list(self.stores.items()):
            self.net.stop_endpoint(ep)
            self.net.unbind(ep)
            await store.shutdown()
        self.stores.clear()

    def busiest_leader(self) -> str:
        return max(self.stores,
                   key=lambda ep: len(self.stores[ep].leader_region_ids()))


async def _run_arm(detection: bool, n_regions: int, n_workers: int,
                   data_path: str, healthy_s: float, fault_s: float,
                   seed: int) -> dict:
    # all three stores share this process's default executor, so the
    # victim's slow fsyncs would queue-starve the healthy stores'
    # flushes (and read as false stalls); separate processes have no
    # such coupling, so give the bench enough threads that it has none
    from concurrent.futures import ThreadPoolExecutor

    asyncio.get_running_loop().set_default_executor(
        ThreadPoolExecutor(max_workers=192, thread_name_prefix="gray-io"))
    os.makedirs(data_path, exist_ok=True)
    chaos = {}
    for ep_i in range(3):
        ep = f"127.0.0.1:{6400 + ep_i}"
        ip, port = ep.rsplit(":", 1)
        chaos[ep] = ChaosDir(os.path.join(data_path,
                                          f"{ip}_{port}")).install()
    c = _Cluster(3, n_regions, data_path, detection)
    rng = random.Random(seed)
    try:
        await c.start()
        pd = FakePlacementDriverClient([r.copy() for r in c.regions])
        kv = RheaKVStore(pd, InProcTransport(c.net, "bench-client:0"),
                         timeout_ms=8000, max_retries=8,
                         batching=BatchingOptions(enabled=True),
                         jitter_seed=seed)
        await kv.start()
        keys = [b"g%06d/x" % rng.randrange(n_regions)
                for _ in range(4 * n_workers)]

        lat: list[tuple[float, float]] = []   # (t_done, latency_s)
        stop = asyncio.Event()

        async def worker(i: int):
            wrng = random.Random(seed * 977 + i)
            n = 0
            while not stop.is_set():
                n += 1
                key = wrng.choice(keys)
                t0 = time.monotonic()
                try:
                    await kv.put(key, b"v%08d" % n)
                    lat.append((time.monotonic(),
                                time.monotonic() - t0))
                except Exception:
                    # bounced past its retries: a max-latency op, so
                    # shedding cannot fake a good p99 by failing fast
                    lat.append((time.monotonic(), 8.0))
            return n

        workers = [asyncio.ensure_future(worker(i))
                   for i in range(n_workers)]

        def window_p99(t_from: float, t_to: float) -> tuple[float, int]:
            w = [d for t, d in lat if t_from <= t < t_to]
            return _p(w, 0.99) * 1000.0, len(w)

        # phase 1: the healthy baseline
        t0 = time.monotonic()
        await asyncio.sleep(healthy_s)
        t_fault = time.monotonic()
        healthy_p99, healthy_n = window_p99(t0 + healthy_s * 0.3, t_fault)

        # phase 2: a sustained slow disk on the busiest leader store,
        # held to the end of the run
        victim = c.busiest_leader()
        led_before = len(c.stores[victim].leader_region_ids())
        chaos[victim].set_slow(fsync_ms=300, write_ms=5, jitter_ms=200,
                               seed=seed)
        await asyncio.sleep(fault_s)
        t_end = time.monotonic()
        # "faulted" = the detection window right after the injection;
        # "recovered" = the last 40 % of the fault phase
        faulted_p99, faulted_n = window_p99(t_fault,
                                            t_fault + fault_s * 0.4)
        recovered_p99, recovered_n = window_p99(t_end - fault_s * 0.4,
                                                t_end)
        stop.set()
        ops = sum(await asyncio.gather(*workers))
        victim_store = c.stores[victim]
        out = {
            "detection": detection,
            "ops": ops,
            "healthy_p99_ms": round(healthy_p99, 1),
            "faulted_p99_ms": round(faulted_p99, 1),
            "recovered_p99_ms": round(recovered_p99, 1),
            "window_ops": [healthy_n, faulted_n, recovered_n],
            "victim": victim,
            "victim_led_regions_before": led_before,
            "victim_led_regions_after":
                len(victim_store.leader_region_ids()),
            "evacuations": sum(s.evacuations for s in c.stores.values()),
            "shed_items": sum(s.kv_processor.shed_items
                              for s in c.stores.values()),
        }
        if victim_store.health is not None:
            out["victim_health"] = victim_store.health.score()
        chaos[victim].heal_slow()   # shut down at disk speed
        await kv.shutdown()
        return out
    finally:
        await c.stop()
        for cd in chaos.values():
            cd.uninstall()


async def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--regions", type=int, default=128)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--healthy-s", type=float, default=10.0)
    ap.add_argument("--fault-s", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (never a committed file)")
    args = ap.parse_args()

    import tempfile

    from bench_torch_plane import host_record

    machine = host_record()
    results = {}
    for detection in (True, False):
        with tempfile.TemporaryDirectory(prefix="tpuraft-torch-gray-") as d:
            arm = await _run_arm(detection, args.regions, args.workers, d,
                                 args.healthy_s, args.fault_s, args.seed)
        arm["faulted_x"] = round(
            arm["faulted_p99_ms"] / max(arm["healthy_p99_ms"], 0.1), 1)
        arm["recovered_x"] = round(
            arm["recovered_p99_ms"] / max(arm["healthy_p99_ms"], 0.1), 1)
        results["on" if detection else "off"] = arm
        print(json.dumps(arm), flush=True)

    record = {
        "bench": "bench_gray",
        "regions": args.regions,
        "workers": args.workers,
        "fault": "sustained slow disk on the busiest leader store "
                 "(fsync +300ms±200, write +5ms) held for the whole "
                 "fault phase",
        "arms": results,
        "claim": "with detection ON, recovered p99 is within ~3x of "
                 "healthy while the fault still holds (evacuation moved "
                 "the leases); with detection OFF it stays >10x",
        "healthy_s": args.healthy_s,
        "fault_s": args.fault_s,
        "seed": args.seed,
        **machine,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    if args.json:
        print(json.dumps(record))
    idle = [name for name, arm in results.items() if arm["ops"] == 0]
    if idle:
        print(f"bench_torch_gray: no op ran in the {idle} arm(s)",
              file=sys.stderr)
    return 1 if idle else 0


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
