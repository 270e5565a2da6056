"""RheaKV multi-region store + YCSB-style benchmark driver.

Reference parity: ``example:rheakv/*`` benchmark (SURVEY.md §3.3) — boots
an N-store, R-region RheaKV cluster in one process (the reference's
benchmark yaml topology), loads keys, then runs a mixed workload and
reports throughput + latency percentiles.

    python -m examples.rheakv_bench                 # defaults: 3x4, quick
    python -m examples.rheakv_bench --regions 16 --keys 20000 --ops 50000 \
        --workload a    # 50/50 read-update (YCSB-A); b = 95/5
    python -m examples.rheakv_bench --transport native --store native \
        --data /tmp/rkv # real epoll sockets + C++ KV engine
"""

from __future__ import annotations

import argparse
import asyncio
import struct
import time

import numpy as np

from tpuraft_torch.rheakv.client import RheaKVStore
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
from tpuraft_torch.options import ReadOnlyOption
from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions
from tpuraft_torch.rpc.transport import InProcNetwork, InProcTransport, RpcServer


def make_regions(n_regions: int, n_keys_space: int = 1 << 32) -> list[Region]:
    """Pre-split the 4-byte big-endian key space into n_regions ranges
    (the reference benchmark pre-splits via PD before loading)."""
    bounds = [int(i * n_keys_space / n_regions) for i in range(n_regions + 1)]
    regions = []
    for i in range(n_regions):
        start = struct.pack(">I", bounds[i]) if i else b""
        end = struct.pack(">I", bounds[i + 1]) if i < n_regions - 1 else b""
        regions.append(Region(id=i + 1, start_key=start, end_key=end))
    return regions


class BenchCluster:
    """N stores x R regions, over in-proc loopback or real sockets
    (``transport``: "inproc" | "tcp" | "native" — the latter two bind
    ephemeral localhost ports; "native" is the C++ epoll engine).
    ``store``: "memory" or "native" (C++ KV engine; needs data_path)."""

    def __init__(self, n_stores: int, regions: list[Region],
                 election_timeout_ms: int = 1000, lease_reads: bool = False,
                 transport: str = "inproc", store: str = "memory",
                 data_path: str = ""):
        self.lease_reads = lease_reads
        self.transport_kind = transport
        self.store_kind = store
        self.data_path = data_path
        self.net = InProcNetwork() if transport == "inproc" else None
        self.n_stores = n_stores
        self.endpoints: list[str] = []
        self.regions = regions
        self.election_timeout_ms = election_timeout_ms
        self.stores: dict[str, StoreEngine] = {}
        self._servers = []
        self._transports = []

    def _transport_classes(self):
        """(server_cls, transport_cls) for the socket fabrics."""
        if self.transport_kind == "tcp":
            from tpuraft_torch.rpc.tcp import TcpRpcServer, TcpTransport
            return TcpRpcServer, TcpTransport
        from tpuraft_torch.rpc.native_tcp import (
            NativeTcpRpcServer,
            NativeTcpTransport,
        )
        return NativeTcpRpcServer, NativeTcpTransport

    async def _make_server(self, i: int):
        if self.transport_kind == "inproc":
            ep = f"127.0.0.1:{6100 + i}"
            server = RpcServer(ep)
            self.net.bind(server)
            return ep, server, InProcTransport(self.net, ep)
        srv_cls, t_cls = self._transport_classes()
        server = srv_cls("127.0.0.1:0")
        await server.start()
        ep = f"127.0.0.1:{server.bound_port}"
        server.endpoint = ep
        return ep, server, t_cls(endpoint=ep)

    def _raw_store_factory(self, ep: str):
        if self.store_kind != "native":
            return None
        import os
        import tempfile

        from tpuraft_torch.rheakv.native_store import NativeRawKVStore
        if not self.data_path:
            # per-run unique: a fixed default would replay a previous
            # run's WAL when the OS reuses an ephemeral port
            self.data_path = tempfile.mkdtemp(prefix="rheakv_bench_")
        base = self.data_path
        os.makedirs(base, exist_ok=True)  # engine mkdirs only the leaf
        return lambda: NativeRawKVStore(f"{base}/{ep.replace(':', '_')}")

    async def start(self) -> None:
        made = []
        for i in range(self.n_stores):
            ep, server, transport = await self._make_server(i)
            # register for cleanup AS EACH is made, so a failure midway
            # (or during store.start below) can't strand io threads/fds
            self._servers.append(server)
            self._transports.append(transport)
            made.append((ep, server, transport))
        self.endpoints = [ep for ep, _, _ in made]
        for r in self.regions:
            r.peers = list(self.endpoints)
        for ep, server, transport in made:
            opts = StoreEngineOptions(
                server_id=ep,
                initial_regions=[r.copy() for r in self.regions],
                election_timeout_ms=self.election_timeout_ms,
                read_only_option=(ReadOnlyOption.LEASE_BASED
                                  if self.lease_reads
                                  else ReadOnlyOption.SAFE))
            factory = self._raw_store_factory(ep)
            if factory is not None:
                opts.raw_store_factory = factory
            store = StoreEngine(opts, server, transport)
            await store.start()
            self.stores[ep] = store

    async def wait_leaders(self, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        want = {r.id for r in self.regions}
        while time.monotonic() < deadline:
            led = set()
            for s in self.stores.values():
                for r in s.list_regions():
                    eng = s.get_region_engine(r.id)
                    if eng and eng.is_leader():
                        led.add(r.id)
            if led >= want:
                return
            await asyncio.sleep(0.05)
        raise TimeoutError("regions without leaders")

    async def client(self, read_preference: str = "leader") -> RheaKVStore:
        pd = FakePlacementDriverClient(
            [r.copy() for r in next(iter(self.stores.values())).list_regions()])
        if self.transport_kind == "inproc":
            t = InProcTransport(self.net, "bench-client:0")
        else:
            t = self._transport_classes()[1]()
        self._client_transport = t
        kv = RheaKVStore(pd, t, read_preference=read_preference)
        await kv.start()
        return kv

    async def stop(self) -> None:
        for ep, s in list(self.stores.items()):
            if self.net is not None:
                self.net.unbind(ep)
            await s.shutdown()
        self.stores.clear()
        for server in self._servers:
            stop = getattr(server, "stop", None)
            if stop is not None:
                await stop()
        self._servers.clear()
        for t in self._transports:
            close = getattr(t, "close", None)
            if close is not None:
                await close()
        self._transports.clear()
        ct = getattr(self, "_client_transport", None)
        if ct is not None and hasattr(ct, "close"):
            await ct.close()


def _key(i: int) -> bytes:
    # spread keys uniformly over the pre-split >I space
    return struct.pack(">I", (i * 2654435761) & 0xFFFFFFFF)


async def run_bench(n_stores: int = 3, n_regions: int = 4,
                    n_keys: int = 2000, n_ops: int = 5000,
                    value_size: int = 100, workload: str = "b",
                    concurrency: int = 64, lease_reads: bool = False,
                    transport: str = "inproc", store: str = "memory",
                    data_path: str = "", verbose: bool = True,
                    read_preference: str = "leader",
                    zipf_theta: float = 0.0) -> dict:
    read_frac = {"a": 0.5, "b": 0.95, "c": 1.0}[workload]
    cluster = BenchCluster(n_stores, make_regions(n_regions),
                           lease_reads=lease_reads, transport=transport,
                           store=store, data_path=data_path)
    value = b"v" * value_size
    rng = np.random.default_rng(0)
    kv = None

    def say(*a):
        if verbose:
            print(*a)

    try:
        # setup inside the try: a wait_leaders timeout must still tear
        # the native io threads / sockets / WAL fds down via finally
        await cluster.start()
        await cluster.wait_leaders()
        kv = await cluster.client(read_preference)
        # -- load phase ----------------------------------------------------
        t0 = time.perf_counter()
        sem = asyncio.Semaphore(concurrency)

        async def put_one(i: int):
            async with sem:
                assert await kv.put(_key(i), value)

        await asyncio.gather(*(put_one(i) for i in range(n_keys)))
        load_s = time.perf_counter() - t0
        say(f"load: {n_keys} keys across {n_regions} regions "
            f"in {load_s:.2f}s ({n_keys / load_s:,.0f} ops/s)")

        # -- mixed phase (YCSB-{a,b,c}; uniform or scrambled-zipfian
        # request distribution, as in the YCSB core workloads) -----------
        ops = rng.random(n_ops) < read_frac
        if zipf_theta > 0:
            ranks = np.arange(1, n_keys + 1, dtype=np.float64)
            weights = ranks ** -zipf_theta
            weights /= weights.sum()
            hot = rng.choice(n_keys, size=n_ops, p=weights)
            # scramble: hot ranks spread over the keyspace (YCSB's
            # ScrambledZipfian), so the hotspot isn't one region
            perm = rng.permutation(n_keys)
            picks = perm[hot]
        else:
            picks = rng.integers(0, n_keys, n_ops)
        lat: list[float] = []
        t0 = time.perf_counter()

        async def one(i: int):
            async with sem:
                s = time.perf_counter()
                if ops[i]:
                    await kv.get(_key(int(picks[i])))
                else:
                    await kv.put(_key(int(picks[i])), value)
                lat.append(time.perf_counter() - s)

        await asyncio.gather(*(one(i) for i in range(n_ops)))
        run_s = time.perf_counter() - t0
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        result = {
            "workload": workload, "transport": transport, "store": store,
            "stores": n_stores, "regions": n_regions,
            "read_preference": read_preference,
            "zipf_theta": zipf_theta,
            "ops_per_s": n_ops / run_s,
            "p50_ms": float(lat_ms[int(0.50 * len(lat_ms))]),
            "p99_ms": float(lat_ms[int(0.99 * len(lat_ms)) - 1]),
        }
        say(f"workload-{workload}: {n_ops} ops ({read_frac:.0%} reads) "
            f"in {run_s:.2f}s -> {result['ops_per_s']:,.0f} ops/s, "
            f"p50 {result['p50_ms']:.2f}ms, p99 {result['p99_ms']:.2f}ms")
        return result
    finally:
        if kv is not None:
            await kv.shutdown()
        await cluster.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stores", type=int, default=3)
    ap.add_argument("--regions", type=int, default=4)
    ap.add_argument("--keys", type=int, default=2000)
    ap.add_argument("--ops", type=int, default=5000)
    ap.add_argument("--value-size", type=int, default=100)
    ap.add_argument("--workload", choices=["a", "b", "c"], default="b")
    ap.add_argument("--concurrency", type=int, default=64)
    ap.add_argument("--lease-reads", action="store_true",
                    help="LEASE_BASED readIndex (no per-read quorum round)")
    ap.add_argument("--transport", choices=["inproc", "tcp", "native"],
                    default="inproc",
                    help="RPC fabric: in-proc loopback, asyncio TCP, or "
                         "the native C++ epoll engine")
    ap.add_argument("--store", choices=["memory", "native"],
                    default="memory",
                    help="data engine: in-memory or the native C++ engine")
    ap.add_argument("--data", default="",
                    help="data dir for --store native")
    ap.add_argument("--zipf", type=float, default=0.0, metavar="THETA",
                    help="scrambled-zipfian request skew (YCSB default "
                         "0.99; 0 = uniform)")
    ap.add_argument("--read-preference", choices=["leader", "any"],
                    default="leader",
                    help="'any' spreads linearizable reads over ALL "
                         "replicas (followers/learners serve via the "
                         "readIndex barrier). NOTE: pays off when "
                         "replicas own separate CPUs (multi-host); in "
                         "this single-process harness the forwarding "
                         "hop only adds latency")
    args = ap.parse_args()
    asyncio.run(run_bench(args.stores, args.regions, args.keys, args.ops,
                          args.value_size, args.workload, args.concurrency,
                          args.lease_reads, args.transport, args.store,
                          args.data, read_preference=args.read_preference,
                          zipf_theta=args.zipf))


if __name__ == "__main__":
    main()
