"""The port's RheaKV store served over its native C++ epoll transport with
its native C++ KV engine underneath: the port copies of the in-process
tests of the JAX package's ``tests/test_kv_over_native_tcp.py``, each
run with the stores' region nodes on their own timers (as the JAX
package runs them) and again driven by one port MultiRaftEngine per
store ticking on the CPU (the shape of ``rheakv_server --engine
--transport native``).

The JAX package's process tests there (``test_proc_*``) spawn servers
whose disk budget reads the filesystem through statvfs; the server
processes of that shape run on the card in chip_smoke.py (leg D).
"""

from __future__ import annotations

import asyncio
import contextlib

import pytest

from tpuraft_torch.core.engine import MultiRaftEngine
from tpuraft_torch.options import TickOptions
from tpuraft_torch.rheakv.client import RheaKVStore
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.native_store import NativeRawKVStore
from tpuraft_torch.rheakv.native_store import ensure_built as kv_built
from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions
from tpuraft_torch.rpc.native_tcp import (
    NativeTcpRpcServer,
    NativeTcpTransport,
    ensure_built,
)

from tests.test_torch_kv import DISK_BUDGET

# how the stores drive their region nodes
DRIVES = ["timers", "engine"]


@pytest.fixture(scope="module", autouse=True)
def built():
    ensure_built()
    kv_built()


class NativeKVCluster:
    """3 port StoreEngines over native epoll servers + native KV engines
    (the port copy of the JAX package's NativeKVCluster).

    `regions_fn(endpoints)` builds the region layout once the ephemeral
    ports are known; `drive="engine"` gives each store a port
    MultiRaftEngine on the CPU.  Owns teardown of every server, store,
    engine, transport and any client made via `client()`.
    """

    def __init__(self, tmp_path, regions_fn=None, drive: str = "timers"):
        self._tmp = tmp_path
        self._regions_fn = regions_fn or (
            lambda eps: [Region(id=1, peers=list(eps))])
        self.drive = drive
        self.servers: list = []
        self.stores: list[StoreEngine] = []
        self.engines: list[MultiRaftEngine] = []
        self.transports: list = []
        self.regions: list[Region] = []
        self._clients: list[RheaKVStore] = []

    async def __aenter__(self) -> "NativeKVCluster":
        for _ in range(3):
            srv = NativeTcpRpcServer("127.0.0.1:0")
            await srv.start()
            srv.endpoint = f"127.0.0.1:{srv.bound_port}"
            self.servers.append(srv)
        endpoints = [s.endpoint for s in self.servers]
        self.regions = self._regions_fn(endpoints)
        for srv in self.servers:
            transport = NativeTcpTransport(endpoint=srv.endpoint)
            self.transports.append(transport)
            opts = StoreEngineOptions(
                server_id=srv.endpoint,
                initial_regions=[r.copy() for r in self.regions],
                data_path=str(self._tmp),
                election_timeout_ms=500,
                disk_budget_bytes=DISK_BUDGET,
                raw_store_factory=lambda ep=srv.endpoint: NativeRawKVStore(
                    str(self._tmp / ("kv_" + ep.replace(":", "_")))),
            )
            engine = None
            if self.drive == "engine":
                engine = MultiRaftEngine(TickOptions(
                    max_groups=16, max_peers=4, tick_interval_ms=20,
                    device="cpu"))
                self.engines.append(engine)
            store = StoreEngine(opts, srv, transport,
                                multi_raft_engine=engine)
            await store.start()
            self.stores.append(store)
        return self

    async def __aexit__(self, *exc):
        for kv in self._clients:
            with contextlib.suppress(Exception):
                await kv.shutdown()
        for s in self.stores:
            await s.shutdown()
        for srv in self.servers:
            await srv.stop()
        for t in self.transports:
            await t.close()

    async def client(self, **kw) -> RheaKVStore:
        transport = NativeTcpTransport()
        self.transports.append(transport)
        pd = FakePlacementDriverClient([r.copy() for r in self.regions])
        kv = RheaKVStore(pd, transport, **kw)
        await kv.start()
        self._clients.append(kv)
        return kv

    async def wait_leader(self, rid: int):
        deadline = asyncio.get_running_loop().time() + 10
        while asyncio.get_running_loop().time() < deadline:
            for s in self.stores:
                re = s.get_region_engine(rid)
                if re is not None and re.is_leader():
                    return re
            await asyncio.sleep(0.05)
        raise TimeoutError(f"no leader for region {rid}")

    async def kill_leader(self, rid: int) -> None:
        """Crash-stop the region leader's whole server process-analog
        (store + server + its outbound transport)."""
        leader = await self.wait_leader(rid)
        i = next(j for j, s in enumerate(self.stores)
                 if s is leader.store_engine)
        await self.stores.pop(i).shutdown()
        await self.servers.pop(i).stop()
        await self.transports.pop(i).close()

    def check_drive(self) -> None:
        """An engine-driven cluster really ticked its regions through
        the port engines."""
        if self.drive == "engine":
            assert self.engines and all(e.ticks > 0 for e in self.engines)
            assert all(e._device.type == "cpu" for e in self.engines)


@pytest.mark.parametrize("drive", DRIVES)
async def test_kv_cluster_over_native_transport_and_engine(tmp_path, drive):
    def two_regions(eps):
        return [Region(id=1, start_key=b"", end_key=b"m", peers=list(eps)),
                Region(id=2, start_key=b"m", end_key=b"", peers=list(eps))]

    async with NativeKVCluster(tmp_path, two_regions, drive) as c:
        kv = await c.client()
        await c.wait_leader(1)
        await c.wait_leader(2)

        assert await kv.put(b"alpha", b"1")
        assert await kv.put(b"zulu", b"2")
        assert await kv.get(b"alpha") == b"1"
        assert await kv.multi_get([b"alpha", b"zulu", b"nope"]) == {
            b"alpha": b"1", b"zulu": b"2", b"nope": None}
        assert await kv.put_list([(b"a%02d" % i, b"v%d" % i)
                                  for i in range(20)])
        rows = await kv.scan(b"a", b"b")
        assert len(rows) == 21  # a00..a19 + alpha
        seq = await kv.get_sequence(b"ids", 10)
        assert seq.end - seq.start == 10
        lock = kv.get_distributed_lock(b"L", lease_ms=5000)
        assert await lock.try_lock()
        await lock.unlock()

        # crash the region-1 leader, survivors re-elect, client fails over
        await c.kill_leader(1)
        await c.wait_leader(1)
        assert await kv.get(b"alpha") == b"1"
        assert await kv.put(b"after", b"failover")
        assert await kv.get(b"after") == b"failover"
        c.check_drive()


@pytest.mark.parametrize("drive", DRIVES)
async def test_native_stack_history_is_linearizable(tmp_path, drive):
    """Full native stack under concurrent load + leader kill, with the
    recorded client history proven linearizable: C++ epoll sockets on
    the wire, C++ KV engine on disk, readIndex barriers over both."""
    from tpuraft_torch.util.linearizability import History, check_history

    async with NativeKVCluster(tmp_path, drive=drive) as c:
        kv = await c.client(max_retries=1)
        await c.wait_leader(1)
        h = History()
        stop = asyncio.Event()
        keys = [b"nl-%d" % i for i in range(3)]

        async def worker(cid):
            n = 0
            while not stop.is_set():
                n += 1
                key = keys[n % len(keys)]
                if n % 2 == 0:
                    val = b"c%d-%d" % (cid, n)
                    tok = h.invoke(cid, "w", (key, val))
                    try:
                        await asyncio.wait_for(kv.put(key, val), 4.0)
                        h.complete(tok, True)
                    except Exception:
                        pass
                else:
                    tok = h.invoke(cid, "r", (key,))
                    try:
                        v = await asyncio.wait_for(kv.get(key), 4.0)
                        h.complete(tok, v)
                    except Exception:
                        pass
                await asyncio.sleep(0.003)

        workers = [asyncio.ensure_future(worker(i)) for i in range(4)]
        await asyncio.sleep(1.2)
        await c.kill_leader(1)       # crash mid-load
        await c.wait_leader(1)
        await asyncio.sleep(1.2)
        stop.set()
        await asyncio.gather(*workers)

        ops = h.ops()
        done = sum(1 for o in ops if o.ret is not None)
        assert done > 100, f"only {done}/{len(ops)} completed"
        rep = check_history(h)
        assert rep.ok, str(rep)
        c.check_drive()
