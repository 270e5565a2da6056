"""Standalone placement-driver server: one OS process per PD member.

Reference parity: ``pd:PlacementDriverServer`` bootable as its own
process (SURVEY.md §3.2 "PD server") — a 1-group raft app holding
cluster metadata, answering routing, and emitting split /
leader-balancing instructions from store heartbeats.

    python -m examples.pd_server --serve 127.0.0.1:9101 \\
        --pd 127.0.0.1:9101,127.0.0.1:9102,127.0.0.1:9103 \\
        --data /tmp/pd1 --split-keys 4096 [--balance-leaders]

Pair with ``examples.rheakv_server --pd ...`` stores: they heartbeat
region meta + stats here and execute the returned instructions.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys

from tpuraft_torch.examples.rheakv_bench import make_regions
from tpuraft_torch.rheakv.pd_server import (
    PlacementDriverOptions,
    PlacementDriverServer,
)


async def serve(endpoint: str, pd_endpoints: list[str], data_path: str,
                split_threshold_keys: int = 0,
                balance_leaders: bool = False,
                seed_regions: int = 0,
                transport_kind: str = "tcp",
                metrics_port: int | None = None,
                lifecycle: bool = False,
                lifecycle_min_regions: int = 4,
                lifecycle_merge_cooldown_s: float = 10.0) -> None:
    if transport_kind == "native":
        from tpuraft_torch.rpc.native_tcp import NativeTcpRpcServer as Server
        from tpuraft_torch.rpc.native_tcp import NativeTcpTransport as Transport
    else:
        from tpuraft_torch.rpc.tcp import TcpRpcServer as Server
        from tpuraft_torch.rpc.tcp import TcpTransport as Transport

    server = Server(endpoint)
    await server.start()
    transport = Transport(endpoint=endpoint)
    opts = PlacementDriverOptions(
        endpoints=list(pd_endpoints),
        data_path=data_path,
        split_threshold_keys=split_threshold_keys,
        balance_leaders=balance_leaders,
        initial_regions=make_regions(seed_regions) if seed_regions else [],
        metrics_port=metrics_port,
        lifecycle=lifecycle,
        lifecycle_min_regions=lifecycle_min_regions,
        lifecycle_merge_cooldown_s=lifecycle_merge_cooldown_s,
    )
    pd = PlacementDriverServer(opts, endpoint, server, transport)
    await pd.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(signal.SIGTERM, stop.set)
        loop.add_signal_handler(signal.SIGINT, stop.set)
    except NotImplementedError:   # non-unix event loop
        pass
    # machine-readable readiness line first (same supervisor contract as
    # examples.rheakv_server), the human line after
    print("READY " + json.dumps({
        "endpoint": endpoint, "pid": os.getpid(),
        "metrics_port": getattr(pd, "metrics_http_port", None)}),
        flush=True)
    print(f"pd member {endpoint} up ({len(pd_endpoints)}-member cluster)",
          flush=True)
    try:
        await stop.wait()
    finally:
        await pd.shutdown()
        await server.stop()
        await transport.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--serve", required=True, help="this member's ip:port")
    ap.add_argument("--pd", required=True,
                    help="comma-separated PD cluster endpoints")
    ap.add_argument("--data", required=True)
    ap.add_argument("--split-keys", type=int, default=0,
                    help="auto-split threshold (0 = off)")
    ap.add_argument("--balance-leaders", action="store_true")
    ap.add_argument("--seed-regions", type=int, default=0,
                    help="pre-split the keyspace into N regions on first "
                         "boot (metadata only; stores attach via "
                         "heartbeats)")
    ap.add_argument("--transport", choices=["tcp", "native"], default="tcp")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve PD Prometheus text at GET /metrics on "
                         "this port (0 = ephemeral; default off)")
    ap.add_argument("--lifecycle", action="store_true",
                    help="run the region lifecycle engine (heat splits, "
                         "cold merges, cross-store moves)")
    ap.add_argument("--lifecycle-min-regions", type=int, default=4,
                    help="never merge the fleet below this many regions")
    ap.add_argument("--lifecycle-merge-cooldown-s", type=float,
                    default=10.0,
                    help="per-region pause between ordered merges")
    args = ap.parse_args()
    pds = [e for e in args.pd.split(",") if e]
    if args.serve not in pds:
        print("error: --serve must be one of --pd", file=sys.stderr)
        sys.exit(2)
    try:
        asyncio.run(serve(
            args.serve, pds, args.data, args.split_keys,
            args.balance_leaders, args.seed_regions,
            args.transport, metrics_port=args.metrics_port,
            lifecycle=args.lifecycle,
            lifecycle_min_regions=args.lifecycle_min_regions,
            lifecycle_merge_cooldown_s=args.lifecycle_merge_cooldown_s))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
