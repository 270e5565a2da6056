"""Standalone RheaKV store server: one OS process per store.

Reference parity: the server side of ``example:rheakv/*`` (SURVEY.md
§3.3) — the reference boots `RheaKVStore` server mains from yaml
topologies; here the topology is CLI flags shared by every member.

    # a 3-store cluster, 4 pre-split regions, durable native engines:
    python -m examples.rheakv_server --serve 127.0.0.1:9001 \\
        --stores 127.0.0.1:9001,127.0.0.1:9002,127.0.0.1:9003 \\
        --regions 4 --data /tmp/rkv1 [--transport native] [--store native]

Every member derives the same region layout from (--stores, --regions),
so a client needs only the store list (see `client_for`); region
discovery and split survival ride the `kv_list_regions` refresh path.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys

from tpuraft_torch.examples.rheakv_bench import make_regions
from tpuraft_torch.rheakv.client import RheaKVStore
from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions


def derive_regions(stores: list[str], n_regions: int):
    regions = make_regions(n_regions)
    for r in regions:
        r.peers = list(stores)
    return regions


async def serve(endpoint: str, stores: list[str], n_regions: int,
                data_path: str, transport_kind: str = "tcp",
                store_kind: str = "memory",
                pd_endpoints: list[str] | None = None,
                log_scheme: str = "file",
                metrics_port: int | None = None,
                eto_ms: int = 1000,
                apply_lane: bool = False,
                engine: bool = False,
                drain_timeout_s: float = 10.0,
                boot_delay_s: float = 0.0) -> None:
    if boot_delay_s:
        # fault-injection hook: a supervised restart that comes up slow
        # (cold page cache, crash-loop backoff) — lets tests prove the
        # readiness probe really gates client traffic
        await asyncio.sleep(boot_delay_s)
    if transport_kind == "native":
        from tpuraft_torch.rpc.native_tcp import NativeTcpRpcServer as Server
        from tpuraft_torch.rpc.native_tcp import NativeTcpTransport as Transport
    else:
        from tpuraft_torch.rpc.tcp import TcpRpcServer as Server
        from tpuraft_torch.rpc.tcp import TcpTransport as Transport

    server = Server(endpoint)
    await server.start()
    transport = Transport(endpoint=endpoint)
    opts = StoreEngineOptions(
        server_id=endpoint,
        initial_regions=derive_regions(stores, n_regions),
        data_path=data_path,
        election_timeout_ms=eto_ms,
        log_scheme=log_scheme,
        metrics_port=metrics_port,
        apply_lane=apply_lane,
    )
    if store_kind == "native":
        from tpuraft_torch.rheakv.native_store import NativeRawKVStore
        base = f"{data_path}/kv_{endpoint.replace(':', '_')}"
        # the C++ engine mkdirs only the leaf — ensure the parents exist
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        opts.raw_store_factory = lambda: NativeRawKVStore(base)
    pd_client = None
    if pd_endpoints:
        from tpuraft_torch.rheakv.pd_client import RemotePlacementDriverClient
        pd_client = RemotePlacementDriverClient(transport, pd_endpoints)
    raft_engine = None
    if engine:
        # ONE MultiRaftEngine drives every region node of this store
        # with a fused [G] tick (StoreEngine starts/stops it); capacity
        # sized to the next power of two above the region count so
        # splits can land without an immediate _grow
        from tpuraft_torch.core.engine import MultiRaftEngine
        from tpuraft_torch.options import TickOptions
        cap = 1 << max(4, (n_regions + 3).bit_length())
        raft_engine = MultiRaftEngine(TickOptions(
            max_groups=cap, max_peers=max(4, len(stores) + 1),
            tick_interval_ms=20))
    engine = StoreEngine(opts, server, transport,
                         multi_raft_engine=raft_engine, pd_client=pd_client)
    await engine.start()
    # SIGTERM = drain: bounce NEW work retryably (ERR_STORE_BUSY), wait
    # for everything already admitted to ack, then exit 0 — the process
    # supervisor's clean-stop contract (SIGKILL is the crash path)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(signal.SIGTERM, stop.set)
        loop.add_signal_handler(signal.SIGINT, stop.set)
    except NotImplementedError:   # non-unix event loop
        pass
    # machine-readable readiness line FIRST (supervisors parse it to
    # gate client traffic), the human line after
    print("READY " + json.dumps({
        "endpoint": endpoint, "pid": os.getpid(),
        "metrics_port": engine.metrics_http_port,
        "regions": n_regions}), flush=True)
    print(f"rheakv store {endpoint} up "
          f"({n_regions} regions, {len(stores)} stores)"
          + (f", /metrics on :{engine.metrics_http_port}"
             if engine.metrics_http_port else ""), flush=True)
    try:
        await stop.wait()
        clean = await engine.drain(drain_timeout_s)
        print("DRAINED " + json.dumps({"clean": bool(clean)}), flush=True)
    finally:
        await engine.shutdown()
        await server.stop()
        await transport.close()


def client_for(stores: list[str], n_regions: int,
               transport=None, **kw) -> RheaKVStore:
    """Client against a cluster started with the same (stores, regions)."""
    if transport is None:
        from tpuraft_torch.rpc.tcp import TcpTransport
        transport = TcpTransport()
    pd = FakePlacementDriverClient(derive_regions(stores, n_regions))
    return RheaKVStore(pd, transport, **kw)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--serve", required=True, help="this store's ip:port")
    ap.add_argument("--stores", required=True,
                    help="comma-separated store endpoints (all members)")
    ap.add_argument("--regions", type=int, default=2)
    ap.add_argument("--data", required=True, help="durable state dir")
    ap.add_argument("--transport", choices=["tcp", "native"], default="tcp")
    ap.add_argument("--log-scheme", choices=["file", "multilog"],
                    default="file",
                    help="per-region segment dirs, or ONE shared C++ journal engine per store (group-commit fsync)")
    ap.add_argument("--store", choices=["memory", "native"],
                    default="memory")
    ap.add_argument("--pd", default="",
                    help="comma-separated PD endpoints: heartbeat region "
                         "meta + stats there and execute its instructions "
                         "(splits, leader transfers)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text at GET /metrics on this "
                         "port (0 = ephemeral, printed at boot); "
                         "omit = off — `admin.py metrics` still scrapes "
                         "over the admin transport")
    ap.add_argument("--eto-ms", type=int, default=1000,
                    help="election timeout (ms)")
    ap.add_argument("--apply-lane", action="store_true",
                    help="run FSM applies + fenced reads on a dedicated "
                         "worker lane thread (one hot store saturates "
                         ">1 core)")
    ap.add_argument("--engine", action="store_true",
                    help="drive all region nodes from ONE MultiRaftEngine "
                         "(fused [G] device/numpy tick) instead of "
                         "per-node timers; witness members, priority "
                         "re-election and device read fences all ride "
                         "the engine lanes")
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    help="seconds to wait for in-flight work on SIGTERM")
    ap.add_argument("--boot-delay", type=float, default=0.0,
                    help="sleep this long before serving (fault-injection "
                         "hook for readiness-gating tests)")
    args = ap.parse_args()
    stores = [s for s in args.stores.split(",") if s]
    if args.serve not in stores:
        print("error: --serve must be one of --stores", file=sys.stderr)
        sys.exit(2)
    try:
        asyncio.run(serve(args.serve, stores, args.regions, args.data,
                          args.transport, args.store,
                          [e for e in args.pd.split(",") if e] or None,
                          log_scheme=args.log_scheme,
                          metrics_port=args.metrics_port,
                          eto_ms=args.eto_ms,
                          apply_lane=args.apply_lane,
                          engine=args.engine,
                          drain_timeout_s=args.drain_timeout,
                          boot_delay_s=args.boot_delay))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
