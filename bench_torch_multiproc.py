#!/usr/bin/env python3
"""The port's region-density store across real OS processes: the
counterpart of ``bench_multiproc.py``, a host-plane A/B.

Each store is its own OS process (``tpuraft_torch.examples.
proc_supervisor`` spawning ``tpuraft_torch.examples.rheakv_server``
mains: own interpreter, own loop, timer-driven regions, no engine), the
client is this process, and they talk over real sockets (the native
transport by default).  No device runs any of it.  Each ``--workers``
phase gives one row, ``row_mp[_<regions>]_w<N>_r0`` as the reference
keys it, with ``topology: "multi-process"``, per-process CPU attribution
(``/proc/<pid>/stat`` utime + stime over the measured window) and each
store's lane metrics from a scrape of its ``/metrics``.

    python3 bench_torch_multiproc.py               # w24 + w256 at 1024 x 3
    python3 bench_torch_multiproc.py --regions 128 --workers 256 --duration 6

Rows print as ``RESULT {...}`` lines and are merged into ``--out``
(default ``chiprun_out/bench_torch_multiproc.json``), each with
``device: null`` and the card's name and power limit beside it, so
every number has its machine.  Exits non-zero when a phase acknowledged
no write.
"""

import argparse
import asyncio
import json
import os
import resource
import shutil
import struct
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench_torch_multiproc.json")


def _self_cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def row_key(args, workers: int) -> str:
    """The key the reference files a phase's row under."""
    key = "row_mp" if args.regions == 1024 else f"row_mp_{args.regions}"
    key += f"_w{workers}_r0"
    if args.no_apply_lane:
        key += "_nolane"
    return key


async def run(args, machine: dict) -> list[dict]:
    from tpuraft_torch.core.lanes import WorkerLane
    from tpuraft_torch.examples.proc_supervisor import (ProcSupervisor,
                                                        StoreProcess,
                                                        free_endpoints,
                                                        server_argv)
    from tpuraft_torch.examples.rheakv_server import client_for
    from tpuraft_torch.rheakv.client import BatchingOptions

    R, S = args.regions, args.stores
    endpoints = free_endpoints(S)
    t0 = time.monotonic()
    sup = ProcSupervisor([
        StoreProcess(ep, server_argv(
            ep, endpoints, R, os.path.join(args.dir, f"store{i}"),
            transport=args.transport, store=args.store,
            log_scheme=args.log_scheme, eto_ms=args.election_timeout_ms,
            apply_lane=not args.no_apply_lane, metrics_port=0))
        for i, ep in enumerate(endpoints)])
    await sup.start(ready_timeout_s=120 + R * 0.1)
    boot_s = time.monotonic() - t0

    if args.transport == "native":
        from tpuraft_torch.rpc.native_tcp import NativeTcpTransport
        transport = NativeTcpTransport()
    else:
        from tpuraft_torch.rpc.tcp import TcpTransport
        transport = TcpTransport()
    encode_lane = None if args.no_encode_lane else WorkerLane("cli-encode")
    client = client_for(
        endpoints, R, transport=transport,
        batching=BatchingOptions(enabled=True, encode_lane=encode_lane),
        timeout_ms=20000, max_retries=10)
    await client.start()

    # leadership convergence, seen from outside (no store handles in
    # this process): sampled writes across the keyspace must land
    t1 = time.monotonic()
    probes = min(R, 64)
    deadline = time.monotonic() + 120 + R * 0.1
    while time.monotonic() < deadline:
        oks = 0
        for i in range(probes):
            key = struct.pack(">I", int((i + 0.5) * (1 << 32) / probes))
            try:
                await asyncio.wait_for(client.put(key + b"/warm", b"w"),
                                       20.0)
                oks += 1
            except Exception:  # noqa: BLE001 — still electing
                pass
        if oks >= int(probes * 0.98):
            break
        await asyncio.sleep(1.0)
    elect_s = time.monotonic() - t1

    payload = b"v" * 32
    rows = []
    for workers in args.worker_phases:
        import random
        ok = [0]
        errs = [0]
        lats: list[float] = []
        stop_at = time.monotonic() + args.duration

        async def worker(wid: int) -> None:
            r = random.Random(wid)
            while time.monotonic() < stop_at:
                key = struct.pack(">I", r.getrandbits(32)) \
                    + b"/%04d" % r.randrange(100)
                t = time.perf_counter()
                try:
                    await client.put(key, payload)
                    ok[0] += 1
                    lats.append(time.perf_counter() - t)
                except Exception:  # noqa: BLE001 — counted
                    errs[0] += 1
                await asyncio.sleep(args.pace_ms / 1e3)

        cpu0 = {p.name: p.cpu_seconds() or 0.0 for p in sup.procs}
        self0 = _self_cpu_s()
        t2 = time.monotonic()
        await asyncio.gather(*(worker(i) for i in range(workers)))
        elapsed = time.monotonic() - t2
        cpu1 = {p.name: p.cpu_seconds() or 0.0 for p in sup.procs}
        self1 = _self_cpu_s()
        lats.sort()
        cpu_stores = {name: round(cpu1[name] - cpu0[name], 2)
                      for name in cpu0}
        scraped = await sup.scrape_all()
        lane_keys = ("lane", "widen", "loop_lag", "draining")
        store_metrics = {
            name: {k: v for k, v in m.items()
                   if any(s in k for s in lane_keys)}
            for name, m in scraped.items()}
        row = {
            "regions": R,
            "stores": S,
            "topology": "multi-process",
            # the processes run in parallel only on the cores the host
            # has: compare rows at equal host_cpus
            "host_cpus": len(os.sched_getaffinity(0)),
            "boot_s": round(boot_s, 1),
            "elect_s": round(elect_s, 1),
            "ops_per_sec": round(ok[0] / elapsed, 1),
            "ok": ok[0],
            "errors": errs[0],
            "ack_p50_ms": round(lats[len(lats) // 2] * 1e3, 2)
            if lats else None,
            "ack_p99_ms": round(lats[int(len(lats) * 0.99)] * 1e3, 2)
            if lats else None,
            "workers": workers,
            "pace_ms": args.pace_ms,
            "read_frac": 0.0,
            "transport": args.transport,
            "store": args.store,
            "apply_lane": not args.no_apply_lane,
            "encode_lane": not args.no_encode_lane,
            # per-process CPU over the measured window: each store's
            # own burn, not a share of one loop's wall clock
            "cpu_s_per_store": cpu_stores,
            "cpu_s_client": round(self1 - self0, 2),
            "cpu_cores_used": round(
                (sum(cpu_stores.values()) + self1 - self0) / elapsed, 2),
            "kv_batch_rpcs_per_s": round(
                client.batch_rpcs / elapsed, 1),
            "kv_batch_items_per_rpc": round(
                client.batch_items / max(1, client.batch_rpcs), 2),
            "store_metrics": store_metrics,
            "row": row_key(args, workers),
            **machine,
        }
        print("RESULT " + json.dumps(row), flush=True)
        rows.append(row)
        # reset the client's batch counters between phases
        client.batch_rpcs = client.batch_items = 0

    await client.shutdown()
    await transport.close()
    if encode_lane is not None:
        await encode_lane.aclose()
    await sup.stop()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--regions", type=int, default=1024)
    ap.add_argument("--stores", type=int, default=3)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--workers", default="24,256",
                    help="comma-separated worker phases (one row each)")
    ap.add_argument("--pace-ms", type=float, default=2.0)
    ap.add_argument("--election-timeout-ms", type=int, default=10000)
    ap.add_argument("--transport", choices=["tcp", "native"],
                    default="native")
    ap.add_argument("--store", choices=["memory", "native"],
                    default="native")
    ap.add_argument("--log-scheme", choices=["file", "multilog"],
                    default="multilog")
    ap.add_argument("--no-apply-lane", action="store_true",
                    help="disable the per-store FSM apply lane (A/B)")
    ap.add_argument("--no-encode-lane", action="store_true",
                    help="disable the client batch-encode lane (A/B)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (never a committed file)")
    ap.add_argument("--dir", default="")
    args = ap.parse_args()
    args.worker_phases = [int(w) for w in args.workers.split(",") if w]

    from bench_torch_plane import host_record

    if args.transport == "native":
        from tpuraft_torch.rpc.native_tcp import ensure_built
        ensure_built()
    if args.store == "native":
        from tpuraft_torch.rheakv.native_store import ensure_built as kv_built
        kv_built()
    if args.log_scheme == "multilog":
        from tpuraft_torch.storage.multilog import ensure_built as ml_built
        ml_built()
    machine = host_record()
    tmp = not args.dir
    if tmp:
        args.dir = tempfile.mkdtemp(
            prefix=f"tpuraft_torch_mp_{args.regions}_")
    t0 = time.monotonic()
    try:
        rows = asyncio.run(run(args, machine))
    finally:
        if tmp:
            shutil.rmtree(args.dir, ignore_errors=True)
    wall = round(time.monotonic() - t0, 1)

    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for row in rows:
        row["wall_s"] = wall
        out[row["row"]] = row
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    for row in rows:
        print(json.dumps({"workers": row["workers"],
                          "ops_per_sec": row["ops_per_sec"],
                          "cpu_cores_used": row["cpu_cores_used"]}),
              flush=True)
    idle = [row["row"] for row in rows if row["ok"] == 0]
    if idle:
        print(f"bench_torch_multiproc: no write acknowledged in {idle}",
              file=sys.stderr)
    return 1 if idle else 0


if __name__ == "__main__":
    sys.exit(main())
