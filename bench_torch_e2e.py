#!/usr/bin/env python3
"""End-to-end multi-raft benchmark of the port: 3 store processes over
the native transport, each with its engine on one CUDA card, the
counterpart of ``bench_e2e.py``.

    python3 bench_torch_e2e.py [--groups 256] [--read-mix 0.95,0.5]
    python3 bench_torch_e2e.py --cpu ...        # the engines on the CPU

Each store process hosts one replica of every group: the C++ epoll
transport between the processes, the shared C++ journal (one fsync per
flush round across groups), one ``MultiRaftEngine`` (P = 4, 10 ms
tick) on ``cuda:0`` driving elections and commits, a store-wide
``ReadConfirmBatcher``.  Group k prefers endpoint k % 3 as its leader;
each store drives the groups it leads (``--window`` batches of
``--batch`` entries in flight per group).  The parent runs a warm-up, the
measured run, one read/write-mix run per ``--read-mix`` fraction, a
low-load latency probe (``LAT``) and a per-stage breakdown (``BRK``)
on store 0, then stops every store and waits for it.

Every engine tick is one fused-tick launch on the card: each store
reports its engine's ticks and launches.  Prints ONE JSON line and
writes it to ``--out`` (default ``chiprun_out/bench_torch_e2e.json``);
exits non-zero if a store fails, exits non-zero, or launched other than
once a tick.  Without a card and without ``--cpu`` it exits with the
engine's own "no CUDA device" error.
"""

import argparse
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time

from bench_torch_scale import device_record, probe_engine

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench_torch_e2e.json")


# ===========================================================================
# store process
# ===========================================================================

async def run_store(args) -> None:
    import resource

    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.core.node import Node
    from tpuraft_torch.core.node_manager import NodeManager
    from tpuraft_torch.core.state_machine import StateMachine
    from tpuraft_torch.entity import PeerId, Task
    from tpuraft_torch.ops import tick
    from tpuraft_torch.options import NodeOptions, TickOptions
    from tpuraft_torch.rheakv.store_engine import ReadConfirmBatcher
    from tpuraft_torch.rpc.native_tcp import (NativeTcpRpcServer,
                                              NativeTcpTransport)

    me = args.index
    endpoints = args.peers.split(",")
    G = args.groups
    base = os.path.join(args.dir, f"store{me}")

    class CountFSM(StateMachine):
        applied = 0

        async def on_apply(self, it):
            while it.valid():
                CountFSM.applied += 1
                it.next()

    server = NativeTcpRpcServer(endpoints[me])
    await server.start()
    manager = NodeManager(server)
    transport = NativeTcpTransport(endpoint=endpoints[me])
    cap = 1 << max(4, (G + 3).bit_length())
    tick.LAUNCHES = 0  # this process's one engine: its launches start here
    engine = MultiRaftEngine(TickOptions(
        max_groups=cap, max_peers=4, tick_interval_ms=10,
        device="cpu" if args.cpu else "cuda:0"))
    await engine.start()
    factory = engine.ballot_box_factory()

    # the store-wide SAFE read-confirmation batcher, the one the KV
    # stack serves its read fences through
    read_batcher = ReadConfirmBatcher()

    nodes = []
    for k in range(G):
        gid = f"g{k}"
        # leader placement: endpoint (k % n) gets the high priority
        peers = [
            PeerId(ep.split(":")[0], int(ep.split(":")[1]), 0,
                   100 if k % len(endpoints) == i else 10)
            for i, ep in enumerate(endpoints)]
        opts = NodeOptions(
            election_timeout_ms=args.election_timeout_ms,
            initial_conf=Configuration(peers),
            fsm=CountFSM(),
            log_uri=f"multilog://{base}/mlog#{gid}",
            raft_meta_uri=(f"file://{base}/meta/{gid}"
                           if args.meta == "file" else "memory://"),
            enable_metrics=False)
        # one multi_heartbeat RPC per endpoint pair per beat interval
        opts.raft_options.coalesce_heartbeats = True
        node = Node(gid, peers[me], opts, transport,
                    ballot_box_factory=factory)
        node.node_manager = manager
        manager.add(node)
        if not await node.init():
            raise RuntimeError(f"init failed {gid}@{me}")
        node.read_only_service.attach_confirm_batcher(read_batcher)
        nodes.append(node)

    print("BOOTED", flush=True)

    # wait for --converge of this store's share of the leaders; the
    # deadline scales with G (O(G) elections over 3 processes)
    want = [n for i, n in enumerate(nodes) if i % len(endpoints) == me]
    deadline = time.monotonic() + 120 + G * 0.06
    while time.monotonic() < deadline:
        n_led = sum(1 for n in want if n.is_leader())
        if n_led >= max(1, int(len(want) * args.converge)):
            break
        await asyncio.sleep(0.5)
    led = [n for n in want if n.is_leader()]
    print(f"LEADING {len(led)}/{len(want)}", flush=True)

    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(
        lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)

    def rss_mb() -> float:
        return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                     / 1024, 1)

    async def measured_run(duration: float, window: int):
        """Windowed pipelined appliers on every locally led group."""
        stop_at = time.monotonic() + duration
        ok = [0]
        errs = [0]
        lats: list[float] = []

        async def drive(node):
            # `window` batches of `batch` entries in flight per group
            batch = args.batch
            sem = asyncio.Semaphore(window)
            payload = b"x" * args.payload

            def batch_cb(t0, sample):
                left = [batch]

                def cb(st):
                    if st.is_ok():
                        ok[0] += 1
                    else:
                        errs[0] += 1
                    left[0] -= 1
                    if left[0] == 0:
                        sem.release()
                        if sample:
                            lats.append(time.perf_counter() - t0)
                return cb

            pending = set()
            i = 0
            if args.pace_ms:
                # paced mode: spread each group's cadence uniformly
                import random
                await asyncio.sleep(random.random() * args.pace_ms / 1e3)
            while time.monotonic() < stop_at:
                if not node.is_leader():
                    # leadership moved (the new leader's store drives
                    # the group): idle instead of writing to a follower
                    await asyncio.sleep(
                        max(args.pace_ms / 1e3, 0.05) if args.pace_ms
                        else 0.05)
                    continue
                await sem.acquire()
                if args.pace_ms:
                    await asyncio.sleep(args.pace_ms / 1e3)
                if errs[0] > ok[0] + 1000:
                    # election churn: back off instead of spinning
                    await asyncio.sleep(0.1)
                i += 1
                t0 = time.perf_counter()
                cb = batch_cb(t0, i % 8 == 0)
                tasks = [Task(data=payload, done=cb) for _ in range(batch)]
                fut = asyncio.ensure_future(node.apply_batch(tasks))
                pending.add(fut)
                fut.add_done_callback(pending.discard)
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            # drain outstanding acks
            for _ in range(window):
                try:
                    await asyncio.wait_for(sem.acquire(), 5.0)
                except asyncio.TimeoutError:
                    break

        t_start = time.monotonic()
        # every local node, gated on live leadership: a group whose
        # leadership moves here mid-window is driven here
        await asyncio.gather(*(drive(n) for n in nodes))
        elapsed = time.monotonic() - t_start
        lats.sort()
        return {
            "ok": ok[0], "errs": errs[0], "elapsed": elapsed,
            "applied": CountFSM.applied,
            "lat_p50_ms": round(lats[len(lats) // 2] * 1e3, 3)
            if lats else None,
            "lat_p99_ms": round(lats[int(len(lats) * 0.99)] * 1e3, 3)
            if lats else None,
            # memory and the event loop's task population at this G
            "rss_mb": rss_mb(),
            "asyncio_tasks": len(asyncio.all_tasks()),
        }

    async def measured_read_mix(duration: float, frac: float):
        """Read/write-mix run: each in-flight slot is a read_index()
        fence (probability ``frac``) or an apply batch.  A read counts
        as one op; the store-wide batcher coalesces every led group's
        fences into shared beat rounds."""
        import random as _rnd

        stop_at = time.monotonic() + duration
        ok = [0]
        errs = [0]
        rlats: list[float] = []

        async def drive(node):
            batch = args.batch
            sem = asyncio.Semaphore(args.window)
            payload = b"x" * args.payload
            rng = _rnd.Random(id(node) & 0xffff)

            def batch_cb():
                left = [batch]

                def cb(st):
                    if st.is_ok():
                        ok[0] += 1
                    else:
                        errs[0] += 1
                    left[0] -= 1
                    if left[0] == 0:
                        sem.release()
                return cb

            async def one_read(sample: bool):
                t0 = time.perf_counter()
                try:
                    # bounded: a read wedged by churn costs one slot
                    await asyncio.wait_for(node.read_index(), 10.0)
                    ok[0] += 1
                    if sample:
                        rlats.append(time.perf_counter() - t0)
                except Exception:  # noqa: BLE001 — election churn etc.
                    errs[0] += 1
                finally:
                    sem.release()

            pending = set()
            i = 0
            while time.monotonic() < stop_at:
                if not node.is_leader():
                    await asyncio.sleep(0.05)
                    continue
                await sem.acquire()
                i += 1
                if rng.random() < frac:
                    fut = asyncio.ensure_future(one_read(i % 4 == 0))
                else:
                    cb = batch_cb()   # one shared countdown a batch
                    tasks = [Task(data=payload, done=cb)
                             for _ in range(batch)]
                    fut = asyncio.ensure_future(node.apply_batch(tasks))
                pending.add(fut)
                fut.add_done_callback(pending.discard)
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            for _ in range(args.window):
                try:
                    await asyncio.wait_for(sem.acquire(), 5.0)
                except asyncio.TimeoutError:
                    break

        t_start = time.monotonic()
        await asyncio.gather(*(drive(n) for n in nodes))
        elapsed = time.monotonic() - t_start
        rlats.sort()
        svc_totals: dict[str, int] = {}
        for n in nodes:
            for k, v in n.read_only_service.counters().items():
                svc_totals[k] = svc_totals.get(k, 0) + v
        return {
            "ok": ok[0], "errs": errs[0], "elapsed": elapsed,
            "read_frac": frac,
            "read_p50_ms": round(rlats[len(rlats) // 2] * 1e3, 3)
            if rlats else None,
            "read_p99_ms": round(rlats[int(len(rlats) * 0.99)] * 1e3, 3)
            if rlats else None,
            "read_plane": dict(read_batcher.counters(), **svc_totals),
        }

    async def latency_probe(n_ops: int):
        """Low-load sequential acks on one group."""
        if not led:
            return {"n": 0}
        node = led[0]
        lats = []
        for _ in range(n_ops):
            fut = loop.create_future()
            t0 = time.perf_counter()
            await node.apply(Task(data=b"lat", done=fut.set_result))
            st = await fut
            if st.is_ok():
                lats.append(time.perf_counter() - t0)
            await asyncio.sleep(0.002)
        lats.sort()
        if not lats:
            return {"n": 0}
        return {
            "n": len(lats),
            "p50_ms": round(lats[len(lats) // 2] * 1e3, 3),
            "p99_ms": round(lats[int(len(lats) * 0.99)] * 1e3, 3),
            "min_ms": round(lats[0] * 1e3, 3),
        }

    async def latency_breakdown(n_ops: int):
        """Per-stage marks along one group's low-load commit-ack path:
        apply -> leader fsync -> RPC (follower fsync inside) -> quorum
        tick -> commit advance -> FSM ack, through wrappers put in for
        the probe and taken out after it."""
        if not led:
            return {"n": 0}
        node = led[0]
        lm = node.log_manager
        box = node.ballot_box
        marks: dict = {}

        orig_flush = lm.flush_staged

        async def flush_wrap(upto=None):
            marks.setdefault("flush_s", time.perf_counter())
            r = await orig_flush(upto)
            marks.setdefault("flush_e", time.perf_counter())
            return r

        orig_call = transport.call

        async def call_wrap(dst, method, req, timeout_ms=None):
            # entry appends ride the send plane's multi_append batches;
            # beats and probes are not the measured path
            entrylike = method == "multi_append" or (
                method == "append_entries"
                and getattr(req, "entries", None))
            if entrylike:
                marks.setdefault("rpc_s", time.perf_counter())
            r = await orig_call(dst, method, req, timeout_ms=timeout_ms)
            if entrylike:
                marks.setdefault("rpc_e", time.perf_counter())
            return r

        orig_tick = engine.tick_once

        def tick_wrap():
            t = time.perf_counter()
            r = orig_tick()
            if "adv" in marks:
                marks.setdefault("tick_s", t)
                marks.setdefault("tick_e", time.perf_counter())
            return r

        orig_adv = box._advance

        def adv_wrap(idx):
            marks.setdefault("adv", time.perf_counter())
            return orig_adv(idx)

        lm.flush_staged = flush_wrap
        transport.call = call_wrap
        engine.tick_once = tick_wrap
        box._advance = adv_wrap
        stages: dict[str, list] = {}
        total = []
        try:
            for _ in range(n_ops):
                marks.clear()
                fut = loop.create_future()
                t0 = time.perf_counter()
                await node.apply(Task(data=b"brk", done=fut.set_result))
                st = await fut
                t_ack = time.perf_counter()
                if not st.is_ok():
                    continue
                rel = {k: (v - t0) * 1e3 for k, v in marks.items()}
                rel["ack"] = (t_ack - t0) * 1e3
                for k, v in rel.items():
                    stages.setdefault(k, []).append(v)
                total.append(rel["ack"])
                await asyncio.sleep(0.002)
        finally:
            lm.flush_staged = orig_flush
            transport.call = orig_call
            engine.tick_once = orig_tick
            box._advance = orig_adv

        def pct(xs, q):
            if not xs:
                return None
            s = sorted(xs)
            return round(s[min(len(s) - 1, int(len(s) * q))], 3)

        p99 = {k: pct(v, 0.99) for k, v in sorted(stages.items())}
        # the tail's dominant start-latency stage: tick_s = the advancing
        # tick scheduled late, rpc_s = the batch RPC's dispatch, flush_s
        # = the fsync's start
        starts = {k: p99[k] for k in ("tick_s", "rpc_s", "flush_s")
                  if p99.get(k) is not None}
        dom = max(starts, key=starts.get) if starts else None
        return {
            "n": len(total),
            "note": "relative ms marks across ops; rpc includes "
                    "follower fsync (multi_append batch RPC); adv = "
                    "quorum commit advanced on the engine; tick = the "
                    "advancing tick's span",
            "stage_p50_ms": {k: pct(v, 0.5)
                             for k, v in sorted(stages.items())},
            "stage_p99_ms": p99,
            "tail_attribution": (
                f"ack p99 {p99.get('ack')}ms: dominant start-latency "
                f"stage at p99 is {dom} ({starts.get(dom)}ms) of "
                + ", ".join(f"{k}={v}ms" for k, v in starts.items())),
        }

    while True:
        line = (await reader.readline()).decode().strip()
        if not line or line == "QUIT":
            break
        cmd = line.split()
        if cmd[0] == "GO":
            res = await measured_run(float(cmd[1]), args.window)
        elif cmd[0] == "RMIX":
            res = await measured_read_mix(float(cmd[1]), float(cmd[2]))
        elif cmd[0] == "LAT":
            res = await latency_probe(int(cmd[1]))
        elif cmd[0] == "BRK":
            res = await latency_breakdown(int(cmd[1]))
        else:
            raise ValueError(f"unknown command {line!r}")
        print("RESULT " + json.dumps(res), flush=True)

    for n in nodes:
        await n.shutdown()
    await engine.shutdown()
    await server.stop()
    await transport.close()
    hist = engine.tick_histograms()
    print("DONE " + json.dumps({
        "engine_ticks": engine.ticks,
        "fused_tick_launches": tick.LAUNCHES,
        "tick_device_ms_p50": hist["tick_device_ms"]["p50"],
        "tick_device_ms_p99": hist["tick_device_ms"]["p99"],
        "tick_total_ms_p50": hist["tick_total_ms"]["p50"],
        "tick_total_ms_p99": hist["tick_total_ms"]["p99"],
        "rss_mb": rss_mb()}), flush=True)


# ===========================================================================
# parent process
# ===========================================================================

def free_ports(n: int) -> list[int]:
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run each store's engine tick on the CPU (the "
                         "plain version; no device figure)")
    ap.add_argument("--groups", type=int, default=256)
    ap.add_argument("--stores", type=int, default=3)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--warmup", type=float, default=3.0)
    ap.add_argument("--window", type=int, default=8,
                    help="outstanding apply batches per led group")
    ap.add_argument("--batch", type=int, default=32,
                    help="entries per apply_batch")
    ap.add_argument("--payload", type=int, default=16)
    ap.add_argument("--pace-ms", type=float, default=0.0,
                    help="per-group pause between batches (0 = saturate)")
    ap.add_argument("--election-timeout-ms", type=int, default=1500)
    ap.add_argument("--converge", type=float, default=0.98,
                    help="fraction of its groups each store must lead "
                         "before the runs (the reference's 0.98; 1.0 "
                         "waits for every group)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the JSON record (never a committed file)")
    ap.add_argument("--meta", default="file", choices=["file", "memory"],
                    help="raft meta storage; 'memory' speeds up boot at "
                         "high G (meta is not on the commit-ack path)")
    ap.add_argument("--read-mix", default="",
                    help="comma-separated read fractions (e.g. "
                         "'0.95,0.5'): after the write run, one read/write "
                         "mix run per fraction (extra.read_mix)")
    ap.add_argument("--skip-brk", action="store_true",
                    help="skip the per-stage breakdown round")
    ap.add_argument("--dir", default="")
    ap.add_argument("--store", action="store_true",
                    help="internal: run as a store process")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--peers", default="")
    args = ap.parse_args()

    if args.store:
        asyncio.run(run_store(args))
        return 0

    import shutil
    import tempfile

    # build the native libraries and the kernels once before spawning
    from tpuraft_torch.rpc.native_tcp import ensure_built as build_transport
    from tpuraft_torch.storage.multilog import ensure_built as build_multilog

    build_multilog()
    build_transport()
    # one engine started before three stores would race three builds
    asyncio.run(probe_engine(args))
    card = device_record(args)["card"]

    workdir = args.dir or tempfile.mkdtemp(prefix="tpuraft_torch_e2e_")
    ports = free_ports(args.stores)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    try:
        for i in range(args.stores):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "bench_torch_e2e.py"),
                 "--store", "--index", str(i), "--peers", peers,
                 "--groups", str(args.groups), "--dir", workdir,
                 "--window", str(args.window), "--batch", str(args.batch),
                 "--payload", str(args.payload),
                 "--pace-ms", str(args.pace_ms),
                 "--meta", args.meta, "--converge", str(args.converge),
                 "--election-timeout-ms", str(args.election_timeout_ms),
                 *(["--cpu"] if args.cpu else [])],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env))

        def expect(p, prefix, timeout_s=180.0):
            import select

            t0 = time.monotonic()
            while True:
                left = timeout_s - (time.monotonic() - t0)
                if left <= 0:
                    raise TimeoutError(f"no {prefix!r} from store")
                # gate readline() on readability: a silent live store
                # must not block past the deadline
                ready, _, _ = select.select([p.stdout], [], [],
                                            min(left, 1.0))
                if not ready:
                    if p.poll() is not None:
                        raise RuntimeError(
                            f"store process died (exit {p.returncode})")
                    continue
                line = p.stdout.readline().decode().strip()
                if line.startswith(prefix):
                    return line
                if not line and p.poll() is not None:
                    raise RuntimeError(
                        f"store process died (exit {p.returncode})")

        for p in procs:
            # boot is O(G) node inits a process
            expect(p, "BOOTED", timeout_s=max(180.0, args.groups * 0.15))
        leading = [expect(p, "LEADING",
                          timeout_s=max(180.0, 150 + args.groups * 0.08))
                   for p in procs]
        n_led = sum(int(s.split()[1].split("/")[0]) for s in leading)

        def round_all(cmd):
            for p in procs:
                p.stdin.write((cmd + "\n").encode())
                p.stdin.flush()
            return [json.loads(expect(p, "RESULT")[len("RESULT "):])
                    for p in procs]

        def round_one(p, cmd):
            # the low-load probes run on one store while the others idle
            p.stdin.write((cmd + "\n").encode())
            p.stdin.flush()
            return json.loads(expect(p, "RESULT")[len("RESULT "):])

        round_all(f"GO {args.warmup}")          # warm-up
        results = round_all(f"GO {args.duration}")
        read_rows = []
        for frac_s in [f for f in args.read_mix.split(",") if f]:
            frac = float(frac_s)
            rr = round_all(f"RMIX {args.duration} {frac}")
            r_ok = sum(r["ok"] for r in rr)
            r_el = max(r["elapsed"] for r in rr)
            plane: dict = {}
            for r in rr:
                for k, v in r.get("read_plane", {}).items():
                    plane[k] = plane.get(k, 0) + v
            read_rows.append({
                "read_frac": frac,
                "ops_per_sec": round(r_ok / r_el, 1),
                "errors": sum(r["errs"] for r in rr),
                "read_p50_ms": [r["read_p50_ms"] for r in rr],
                "read_p99_ms": [r["read_p99_ms"] for r in rr],
                "read_plane": plane,
            })
        lat = round_one(procs[0], "LAT 200")    # low-load single-group acks
        brk = (None if args.skip_brk
               else round_one(procs[0], "BRK 150"))  # per-stage breakdown
        for p in procs:
            p.stdin.write(b"QUIT\n")
            p.stdin.flush()
        done = [json.loads(expect(p, "DONE")[len("DONE "):]) for p in procs]
        rcs = [p.wait(timeout=120) for p in procs]

        total_ok = sum(r["ok"] for r in results)
        elapsed = max(r["elapsed"] for r in results)
        cps = total_ok / elapsed
        launches = [d["fused_tick_launches"] for d in done]
        ticks = [d["engine_ticks"] for d in done]
        out = {
            "metric": "e2e_multiraft_commits_per_sec",
            "value": round(cps, 1),
            "unit": "commits/s",
            "topology": "single-host",
            "extra": {
                "groups": args.groups, "stores": args.stores,
                "leaders_placed": n_led,
                "payload_bytes": args.payload,
                "window_per_group": args.window,
                "duration_s": args.duration,
                "errors": sum(r["errs"] for r in results),
                "per_store_cps": [round(r["ok"] / r["elapsed"], 1)
                                  for r in results],
                "underload_ack_p50_ms": [r["lat_p50_ms"] for r in results],
                "underload_ack_p99_ms": [r["lat_p99_ms"] for r in results],
                "lowload_single_group_ack": lat,
                "ack_breakdown": brk,
                "read_mix": read_rows,
                "rss_mb_per_store": [r.get("rss_mb") for r in results],
                "asyncio_tasks_per_store": [r.get("asyncio_tasks")
                                            for r in results],
                "host_cores": os.cpu_count(),
                "per_core_commits_per_sec": round(
                    cps / max(1, os.cpu_count()), 1),
                "stack": "native-tcp + multilog(shared fsync) + "
                         "engine plane (fused tick on the device) + "
                         "priority placement",
                "device": "cpu" if args.cpu else "cuda:0",
                "card": card,
                "engine_ticks_per_store": ticks,
                "fused_tick_launches_per_store": launches,
                "tick_device_ms_p50_per_store": [
                    d["tick_device_ms_p50"] for d in done],
                "tick_device_ms_p99_per_store": [
                    d["tick_device_ms_p99"] for d in done],
                "tick_total_ms_p50_per_store": [
                    d["tick_total_ms_p50"] for d in done],
                "tick_total_ms_p99_per_store": [
                    d["tick_total_ms_p99"] for d in done],
                "store_exit_codes": rcs,
            },
        }
        print(json.dumps(out))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        bad = [f"store {i} exited {rc}" for i, rc in enumerate(rcs) if rc]
        want = [0] * len(ticks) if args.cpu else ticks
        if launches != want:
            bad.append(f"fused-tick launches {launches} for engine ticks "
                       f"{ticks}")
        if bad:
            print("bench_torch_e2e: " + "; ".join(bad), file=sys.stderr)
            return 1
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait()
        if not args.dir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
