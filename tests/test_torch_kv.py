"""The port's engine-backed RheaKV store on the CPU, against the JAX
package's store.

The same seeded script of KV operations runs through a durable 3-store
cluster of each package (the JAX engine on the CPU, the port's torch
engine with ``device="cpu"``), on ``file://`` logs and the memory store
and again on the multilog journal and the native KV engine: every result
and every replica's final scan must be equal.  The port also reopens
data directories the JAX package's store wrote (and the JAX package the
port's).  The rest are port copies of the JAX package's engine-backed KV
tests, a store whose snapshots the tick's ``snap_due`` lane drives, and
the native storage and the native transport behind the server and the
store.
"""

from __future__ import annotations

import asyncio
import contextlib
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

from tpuraft_torch.core.engine import MultiRaftEngine
from tpuraft_torch.options import TickOptions
from tpuraft_torch.rheakv.client import BatchingOptions, RheaKVStore
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.pd_client import FakePlacementDriverClient
from tpuraft_torch.rheakv.region_engine import RegionEngine
from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions
from tpuraft_torch.rpc.transport import InProcNetwork, InProcTransport, RpcServer

ROOT = Path(__file__).resolve().parent.parent
# an explicit budget: a statvfs-derived one reads a nearly full shared
# filesystem as FULL and sheds every write
DISK_BUDGET = 1 << 30


class KVTestCluster:
    """N port StoreEngines in one process over the loopback transport
    (the port's copy of ``tests/kv_cluster.py``'s KVTestCluster)."""

    __test__ = False

    def __init__(self, n_stores: int = 3, tmp_path=None,
                 regions: Optional[list[Region]] = None,
                 election_timeout_ms: int = 300,
                 multi_raft_engine_factory=None,
                 log_scheme: str = "file",
                 store_opts: Optional[dict] = None,
                 raw_store_factory=None):
        self.net = InProcNetwork()
        self.endpoints = [f"127.0.0.1:{6000 + i}" for i in range(n_stores)]
        peers = list(self.endpoints)
        if regions is None:
            regions = [Region(id=1, peers=peers)]
        else:
            for r in regions:
                if not r.peers:
                    r.peers = list(peers)
        self.region_template = [r.copy() for r in regions]
        self.tmp_path = tmp_path
        self.election_timeout_ms = election_timeout_ms
        self.engine_factory = multi_raft_engine_factory
        self.log_scheme = log_scheme
        self.store_opts = dict(store_opts or {})
        self.raw_store_factory = raw_store_factory  # endpoint -> RawKVStore
        self.stores: dict[str, StoreEngine] = {}

    async def start_all(self) -> None:
        for ep in self.endpoints:
            await self.start_store(ep)

    async def start_store(self, endpoint: str) -> StoreEngine:
        server = RpcServer(endpoint)
        self.net.bind(server)
        self.net.start_endpoint(endpoint)
        transport = InProcTransport(self.net, endpoint)
        opts = StoreEngineOptions(
            server_id=endpoint,
            initial_regions=[r.copy() for r in self.region_template],
            data_path=str(self.tmp_path) if self.tmp_path else "",
            election_timeout_ms=self.election_timeout_ms,
            log_scheme=self.log_scheme,
        )
        for k, v in self.store_opts.items():
            setattr(opts, k, v)
        if self.raw_store_factory is not None:
            opts.raw_store_factory = \
                lambda: self.raw_store_factory(endpoint)
        engine = self.engine_factory() if self.engine_factory else None
        store = StoreEngine(opts, server, transport, multi_raft_engine=engine)
        self.stores[endpoint] = store
        await store.start()
        return store

    async def stop_store(self, endpoint: str) -> None:
        self.net.stop_endpoint(endpoint)
        store = self.stores.pop(endpoint, None)
        if store:
            self.net.unbind(endpoint)
            await store.shutdown()

    async def stop_all(self) -> None:
        for ep in list(self.stores):
            await self.stop_store(ep)

    def client_transport(self, endpoint: str = "kvclient:0") -> InProcTransport:
        return InProcTransport(self.net, endpoint)

    async def wait_region_leader(self, region_id: int, timeout_s: float = 5.0
                                 ) -> RegionEngine:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            leaders = [s.get_region_engine(region_id)
                       for s in self.stores.values()
                       if s.get_region_engine(region_id)
                       and s.get_region_engine(region_id).is_leader()]
            if len(leaders) == 1:
                return leaders[0]
            await asyncio.sleep(0.02)
        raise TimeoutError(f"no leader for region {region_id} in {timeout_s}s")

    async def wait_region_on_all(self, region_id: int, timeout_s: float = 5.0
                                 ) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(s.get_region_engine(region_id) is not None
                   for s in self.stores.values()):
                return
            await asyncio.sleep(0.02)
        raise TimeoutError(f"region {region_id} not on all stores")


def torch_engine(max_groups: int, tick_interval_ms: int = 2,
                 backend: str = "torch"):
    """A factory of port engines ticking on the CPU: the torch tick's
    plain version, or with ``backend="numpy"`` the engine's numpy tick
    (the one the JAX package's engine runs on a CPU host)."""
    def factory():
        return MultiRaftEngine(TickOptions(
            max_groups=max_groups, max_peers=4,
            tick_interval_ms=tick_interval_ms, device="cpu",
            backend=backend))
    return factory


def prefix_regions(n: int) -> list[Region]:
    """n key-range regions over 1-byte prefixes (the JAX package's
    64-region test layout)."""
    step = 256 // n
    bounds = [bytes([i * step]) for i in range(n)] + [b""]
    return [Region(id=i + 1, start_key=bounds[i] if i else b"",
                   end_key=bounds[i + 1]) for i in range(n)]


@contextlib.asynccontextmanager
async def kv_client_cluster(cluster_cls=KVTestCluster, client_mods=None,
                            batching=None, **kw):
    """A started cluster and a client over it (the JAX package's
    ``kv_client_cluster`` for either package)."""
    if client_mods is None:
        fake_pd, store_cls = FakePlacementDriverClient, RheaKVStore
    else:
        fake_pd, store_cls = client_mods
    c = cluster_cls(3, **kw)
    try:
        await c.start_all()
        pd = fake_pd(c.region_template)
        pd._regions = {r.id: r.copy() for r in
                       next(iter(c.stores.values())).list_regions()}
        client = store_cls(pd, c.client_transport(), batching=batching)
        await client.start()
        try:
            yield c, client
        finally:
            await client.shutdown()
    finally:
        await c.stop_all()


async def wait_leaders(c, n_regions: int, timeout_s: float = 30.0) -> None:
    for rid in range(1, n_regions + 1):
        await c.wait_region_leader(rid, timeout_s=timeout_s)


async def get_until_acked(kv, key: bytes, timeout_s: float = 30.0):
    """A read retried while the region's leadership settles (EAGAIN,
    ENEWLEADER), as a client rides out an election."""
    from tpuraft_torch.errors import RaftError
    from tpuraft_torch.rheakv.client import RheaKVError

    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return await kv.get(key)
        except RheaKVError as exc:
            if exc.status.code not in (RaftError.EAGAIN,
                                       RaftError.ENEWLEADER) \
                    or time.monotonic() >= deadline:
                raise
        await asyncio.sleep(0.1)


async def converged_scans(c, timeout_s: float = 10.0) -> list:
    """Every replica's full scan, once all replicas agree."""
    deadline = time.monotonic() + timeout_s
    while True:
        scans = [s.raw_store.scan(b"", b"") for s in c.stores.values()]
        if all(sc == scans[0] for sc in scans) or \
                time.monotonic() >= deadline:
            return scans
        await asyncio.sleep(0.05)


# -- (a) the differential -------------------------------------------------------

def kv_script(seed: int, n: int = 60) -> list[tuple]:
    """A seeded sequence of KV operations over a small key space that
    spans every region (keys lead with a byte drawn over 0..255)."""
    rng = np.random.default_rng(seed)
    keys = [bytes([int(b)]) + b"-k%d" % i
            for i, b in enumerate(rng.integers(0, 256, 24))]
    ops = []
    for i in range(n):
        k = keys[int(rng.integers(len(keys)))]
        v = b"v%d-%d" % (i, int(rng.integers(1000)))
        kind = int(rng.integers(10))
        if kind == 0:
            ops.append(("put", k, v))
        elif kind == 1:
            ops.append(("get", k))
        elif kind == 2:
            pick = rng.choice(len(keys), 4, replace=False)
            ops.append(("put_list", [(keys[int(j)], v + b"/%d" % int(j))
                                     for j in pick]))
        elif kind == 3:
            pick = rng.choice(len(keys), 5, replace=False)
            ops.append(("multi_get", [keys[int(j)] for j in pick]))
        elif kind == 4:
            # put, then compare against what it wrote or a stale value
            ops.append(("put", k, v))
            ops.append(("compare_and_put", k,
                        v if rng.random() < 0.5 else b"stale", v + b"-cas"))
        elif kind == 5:
            ops.append(("delete", k))
        elif kind == 6:
            a, b = sorted(bytes([int(x)]) for x in rng.integers(0, 256, 2))
            ops.append(("delete_range", a, b))
        elif kind == 7:
            a, b = sorted(bytes([int(x)]) for x in rng.integers(0, 256, 2))
            ops.append(("scan", a, b))
        elif kind == 8:
            ops.append(("get_sequence", b"seq-%d" % int(rng.integers(2)),
                        int(rng.integers(1, 5))))
        else:
            ops.append(("put", k, v))
    # a full scan at the end reads back every region
    ops.append(("scan", b"", b""))
    return ops


async def run_script(kv, ops) -> list:
    out = []
    for op in ops:
        name, args = op[0], op[1:]
        if name == "get_sequence":
            seq = await kv.get_sequence(*args)
            res = (seq.start, seq.end)
        elif name == "multi_get":
            res = sorted((await kv.multi_get(args[0])).items())
        else:
            res = await getattr(kv, name)(*args)
        out.append((name, res))
    return out


def jax_cluster_kw(tmp_path, n_regions: int):
    """A durable JAX-package cluster whose stores each run the JAX engine
    on the CPU."""
    import tpuraft.core.engine as jengine
    import tpuraft.options as joptions
    from tpuraft.rheakv.metadata import Region as JRegion

    def factory():
        return jengine.MultiRaftEngine(joptions.TickOptions(
            max_groups=n_regions + 4, max_peers=4, tick_interval_ms=2,
            backend="jax"))

    regions = [JRegion(id=r.id, start_key=r.start_key, end_key=r.end_key)
               for r in prefix_regions(n_regions)]
    return dict(tmp_path=tmp_path, regions=regions,
                election_timeout_ms=1000, multi_raft_engine_factory=factory,
                store_opts={"disk_budget_bytes": DISK_BUDGET})


def jax_client_mods():
    from tpuraft.rheakv.client import RheaKVStore as JStore
    from tpuraft.rheakv.pd_client import FakePlacementDriverClient as JPD
    return JPD, JStore


@pytest.mark.parametrize("seed", [0, 1])
async def test_kv_script_matches_jax_store(tmp_path, seed):
    """(a) One seeded script through both packages' durable engine-backed
    stores: the same result for every operation and the same final scan
    on every replica."""
    from tests.kv_cluster import KVTestCluster as JCluster

    n_regions, ops = 4, kv_script(seed)
    results, scans = {}, {}
    async with kv_client_cluster(
            cluster_cls=JCluster, client_mods=jax_client_mods(),
            **jax_cluster_kw(tmp_path / "jax", n_regions)) as (c, kv):
        await wait_leaders(c, n_regions)
        results["jax"] = await run_script(kv, ops)
        scans["jax"] = await converged_scans(c)
    async with kv_client_cluster(
            tmp_path=tmp_path / "torch", regions=prefix_regions(n_regions),
            election_timeout_ms=1000,
            multi_raft_engine_factory=torch_engine(n_regions + 4),
            store_opts={"disk_budget_bytes": DISK_BUDGET}) as (c, kv):
        await wait_leaders(c, n_regions)
        results["torch"] = await run_script(kv, ops)
        scans["torch"] = await converged_scans(c)
    assert results["torch"] == results["jax"]
    assert len(scans["torch"]) == len(scans["jax"]) == 3
    for s in scans["torch"] + scans["jax"]:
        assert s == scans["jax"][0]
    assert scans["jax"][0] == results["jax"][-1][1]  # the final scan op
    cas = [r[1] for r in results["jax"] if r[0] == "compare_and_put"]
    assert True in cas and False in cas


def native_storage_kw(pkg: str, root) -> dict:
    """The region-density configuration's storage (bench_region_density.py):
    every store's regions on one multilog journal and one multimeta
    journal, its data on the package's native KV engine."""
    if pkg == "jax":
        from tpuraft.rheakv.native_store import NativeRawKVStore, ensure_built
    else:
        from tpuraft_torch.rheakv.native_store import (NativeRawKVStore,
                                                       ensure_built)
    ensure_built()
    root.mkdir(parents=True, exist_ok=True)
    return dict(log_scheme="multilog", raw_store_factory=lambda ep:
                NativeRawKVStore(str(root / ("kv_" + ep.replace(":", "_")))))


@pytest.mark.parametrize("seed", [0, 1])
async def test_kv_script_matches_jax_store_on_native_storage(tmp_path, seed):
    """(a) again on the native storage stack: the multilog and multimeta
    journals under every store's regions and the native KV engine under
    its data, in both packages: the same result for every operation and
    the same final scan on every replica."""
    from tests.kv_cluster import KVTestCluster as JCluster

    n_regions, ops = 4, kv_script(seed)
    results, scans = {}, {}
    async with kv_client_cluster(
            cluster_cls=JCluster, client_mods=jax_client_mods(),
            **jax_cluster_kw(tmp_path / "jax", n_regions),
            **native_storage_kw("jax", tmp_path / "jax")) as (c, kv):
        await wait_leaders(c, n_regions)
        results["jax"] = await run_script(kv, ops)
        scans["jax"] = await converged_scans(c)
        assert type(c.stores[c.endpoints[0]].raw_store).__module__ == \
            "tpuraft.rheakv.native_store"
    async with kv_client_cluster(
            tmp_path=tmp_path / "torch", regions=prefix_regions(n_regions),
            election_timeout_ms=1000,
            multi_raft_engine_factory=torch_engine(n_regions + 4),
            store_opts={"disk_budget_bytes": DISK_BUDGET},
            **native_storage_kw("torch", tmp_path / "torch")) as (c, kv):
        await wait_leaders(c, n_regions)
        results["torch"] = await run_script(kv, ops)
        scans["torch"] = await converged_scans(c)
        assert type(c.stores[c.endpoints[0]].raw_store).__module__ == \
            "tpuraft_torch.rheakv.native_store"
    for pkg in ("jax", "torch"):  # one journal per store, no region logs
        assert len(list((tmp_path / pkg).glob("*/mlog"))) == 3
        assert not list((tmp_path / pkg).glob("*/r*/log"))
    assert results["torch"] == results["jax"]
    assert len(scans["torch"]) == len(scans["jax"]) == 3
    for s in scans["torch"] + scans["jax"]:
        assert s == scans["jax"][0]
    assert scans["jax"][0] == results["jax"][-1][1]


# -- (b) the port opens the JAX package's data directory -------------------------

async def test_port_serves_a_jax_store_data_directory(tmp_path):
    """(b) The JAX package's durable store writes keys and snapshots half
    of its regions; the port's store reopens the same directory and
    serves every key from every replica."""
    from tests.kv_cluster import KVTestCluster as JCluster

    n_regions = 8
    kvs = [(bytes([i * 256 // 40]) + b"-carry%d" % i, b"val%d" % i)
           for i in range(40)]
    async with kv_client_cluster(
            cluster_cls=JCluster, client_mods=jax_client_mods(),
            **jax_cluster_kw(tmp_path, n_regions)) as (c, kv):
        await wait_leaders(c, n_regions)
        assert await kv.put_list(kvs)
        await converged_scans(c)
        snapped = 0
        for rid in range(2, n_regions + 1, 2):
            for s in c.stores.values():
                st = await s.get_region_engine(rid).node.snapshot()
                assert st.is_ok(), str(st)
                snapped += 1
        assert snapped == 3 * n_regions // 2
    snap_dirs = list(tmp_path.glob("*/r2/snapshot/snapshot_*"))
    assert len(snap_dirs) == 3
    async with kv_client_cluster(
            tmp_path=tmp_path, regions=prefix_regions(n_regions),
            election_timeout_ms=1000,
            multi_raft_engine_factory=torch_engine(n_regions + 4),
            store_opts={"disk_budget_bytes": DISK_BUDGET}) as (c, kv):
        await wait_leaders(c, n_regions)
        got = await kv.multi_get([k for k, _ in kvs])
        assert got == dict(kvs)
        scans = await converged_scans(c)
        for s in scans:
            assert s == sorted(kvs)
        loaded = sum(
            s.get_region_engine(rid).node.snapshot_executor
            .last_snapshot_id.index > 0
            for s in c.stores.values() for rid in range(1, n_regions + 1))
        assert loaded == 3 * n_regions // 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
async def test_native_store_data_directory_opens_across_packages(
        tmp_path, writer):
    """(b) on the native storage stack, both ways: one package's durable
    store writes keys over the multilog journal, the multimeta journal
    and the native KV engine; the other package's store reopens the same
    directory and serves every key from every replica."""
    from tests.kv_cluster import KVTestCluster as JCluster

    n_regions = 4
    kvs = [(bytes([i * 256 // 24]) + b"-nat%d" % i, b"val%d" % i)
           for i in range(24)]
    jax_kw = dict(cluster_cls=JCluster, client_mods=jax_client_mods(),
                  **jax_cluster_kw(tmp_path, n_regions),
                  **native_storage_kw("jax", tmp_path))
    torch_kw = dict(tmp_path=tmp_path, regions=prefix_regions(n_regions),
                    election_timeout_ms=1000,
                    multi_raft_engine_factory=torch_engine(n_regions + 4),
                    store_opts={"disk_budget_bytes": DISK_BUDGET},
                    **native_storage_kw("torch", tmp_path))
    first, second = (jax_kw, torch_kw) if writer == "jax" \
        else (torch_kw, jax_kw)
    async with kv_client_cluster(**first) as (c, kv):
        await wait_leaders(c, n_regions)
        assert await kv.put_list(kvs)
        for s in await converged_scans(c):
            assert s == sorted(kvs)
    async with kv_client_cluster(**second) as (c, kv):
        await wait_leaders(c, n_regions)
        assert await kv.multi_get([k for k, _ in kvs]) == dict(kvs)
        for s in await converged_scans(c):
            assert s == sorted(kvs)


# -- (c) port copies of the JAX package's engine-backed KV tests ----------------

async def test_kv_over_device_commit_plane():
    """Regions' quorum bookkeeping on the port engine's [G,P] tick (the
    torch backend on the CPU)."""
    async with contextlib.AsyncExitStack() as stack:
        c = KVTestCluster(multi_raft_engine_factory=torch_engine(8))
        stack.push_async_callback(c.stop_all)
        await c.start_all()
        leader = await c.wait_region_leader(1)
        rs = leader.raft_store
        for i in range(10):
            assert await rs.put(b"e%d" % i, b"v%d" % i)
        assert await rs.get(b"e7") == b"v7"
        await asyncio.sleep(0.2)
        for s in c.stores.values():
            assert s.raw_store.get(b"e9") == b"v9"


async def test_64_region_store_with_engine_plane():
    """64 regions x 3 stores, every store batching all its regions'
    quorum math through one port engine on the CPU, batched client ops
    spread across every region."""
    regions = prefix_regions(64)
    async with kv_client_cluster(
            regions=regions, election_timeout_ms=1000,
            multi_raft_engine_factory=torch_engine(72),
            batching=BatchingOptions(enabled=True)) as (c, kv):
        await wait_leaders(c, 64)
        keys = [bytes([i * 4]) + b"-k" for i in range(64)]
        oks = await asyncio.gather(*[kv.put(k, b"v-" + k) for k in keys])
        assert all(oks)
        got = await kv.multi_get(keys)
        assert all(got[k] == b"v-" + k for k in keys)
        rows = await kv.scan(b"", b"")
        assert [k for k, _ in rows] == sorted(keys)
        advances = sum(s.multi_raft_engine.commit_advances
                       + s.multi_raft_engine.eager_commits
                       for s in c.stores.values())
        assert advances >= 64, advances


async def test_split_on_full_engine_grows_plane():
    """A region split on a store whose port engine is at capacity grows
    the [G, P] plane instead of crashing the new RegionEngine."""
    engines = []

    def factory():
        e = torch_engine(1)()
        engines.append(e)
        return e

    c = KVTestCluster(multi_raft_engine_factory=factory)
    try:
        await c.start_all()
        leader = await c.wait_region_leader(1)
        rs = leader.raft_store
        for i in range(32):
            assert await rs.put(b"gk%02d" % i, b"v%d" % i)
        assert all(e.G == 1 for e in engines)
        st = await leader.store_engine.apply_split(1, 2)
        assert st.is_ok(), str(st)
        await c.wait_region_on_all(2)
        l2 = await c.wait_region_leader(2)
        assert all(e.G == 2 for e in engines), [e.G for e in engines]
        assert await leader.raft_store.get(b"gk00") == b"v0"
        assert await l2.raft_store.put(b"zz-new", b"after-grow")
        assert await l2.raft_store.get(b"zz-new") == b"after-grow"
    finally:
        await c.stop_all()


async def test_snap_due_snapshots_an_engine_backed_store(tmp_path):
    """The tick's snap_due lane drives the snapshots of every store that
    leads a region (engine-backed nodes have no snapshot timer), the log
    compacts behind them, and a restarted store reloads its snapshots and
    serves their keys.  A store whose regions all follow is left out: its
    engine sleeps until a deadline its tick owns, and the snapshot
    deadline is not among them (the JAX package's engine alike)."""
    n_regions = 2
    kw = dict(tmp_path=tmp_path, regions=prefix_regions(n_regions),
              election_timeout_ms=1000,
              multi_raft_engine_factory=torch_engine(n_regions + 4),
              store_opts={"disk_budget_bytes": DISK_BUDGET,
                          "snapshot_interval_secs": 1})
    kvs = [(bytes([i * 16]) + b"-s", b"%d" % i) for i in range(16)]
    async with kv_client_cluster(**kw) as (c, kv):
        await wait_leaders(c, n_regions)
        for s in c.stores.values():
            for rid in (1, 2):
                assert s.get_region_engine(rid).node._snapshot_timer is None
        assert await kv.put_list(kvs)
        await converged_scans(c)  # every replica has applied the keys
        leading = [ep for ep, s in c.stores.items()
                   if s.leader_region_ids()]
        nodes = [c.stores[ep].get_region_engine(rid).node
                 for ep in leading for rid in (1, 2)]
        # a follower region restarts from its snapshot alone until its
        # leader's commit index reaches it: wait for snapshots past the
        # keys, not only for a first snapshot
        applied = [n.fsm_caller.last_applied_index for n in nodes]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                n.metrics.counters["snapshots-saved"] >= 1
                and n.log_manager.first_log_index() > 1
                and n.snapshot_executor.last_snapshot_id.index >= a
                for n, a in zip(nodes, applied)):
            await asyncio.sleep(0.05)
        assert all(n.metrics.counters["snapshots-saved"] >= 1
                   for n in nodes)
        assert all(n.log_manager.first_log_index() > 1 for n in nodes)
        victim = leading[0]
        await c.stop_store(victim)
        store = await c.start_store(victim)
        for rid in (1, 2):
            ex = store.get_region_engine(rid).node.snapshot_executor
            assert ex.last_snapshot_id.index > 0
        for k, v in kvs:
            assert store.raw_store.get(k) == v
        # the restart may move leadership: read once every region leads
        await wait_leaders(c, n_regions)
        assert await get_until_acked(kv, kvs[0][0]) == kvs[0][1]


# -- (d) the server, and what the port refuses ------------------------------------

def free_endpoint() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_server_without_a_card_exits_with_the_engine_error(tmp_path):
    """The server copy's --engine runs TickOptions' defaults (torch on
    CUDA): without a card it exits non-zero with the engine's error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the server would start")
    ep = free_endpoint()
    proc = subprocess.run(
        [sys.executable, "-m", "tpuraft_torch.examples.rheakv_server",
         "--serve", ep, "--stores", ep, "--regions", "2",
         "--data", str(tmp_path), "--engine"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "READY" not in proc.stdout


def test_server_refuses_the_native_store(tmp_path):
    """The server copy serves ``--store native --log-scheme multilog``
    (it refused the native KV engine until the port carried one): a
    one-store cluster on the CPU timer plane takes a write over TCP,
    drains on SIGTERM and leaves the native KV engine's files and the
    shared journal in its data directory."""
    import json
    import signal

    from tpuraft_torch.rheakv.native_store import ensure_built

    ensure_built()  # the server opens the engine without building it
    ep = free_endpoint()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuraft_torch.examples.rheakv_server",
         "--serve", ep, "--stores", ep, "--regions", "2",
         "--data", str(tmp_path), "--store", "native",
         "--log-scheme", "multilog", "--eto-ms", "300"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), (line, proc.stderr.read()
                                           if proc.poll() is not None
                                           else "")

        async def put_get():
            from tpuraft_torch.examples.rheakv_server import client_for
            from tpuraft_torch.rpc.tcp import TcpTransport

            t = TcpTransport()
            kv = client_for([ep], 2, transport=t)
            await kv.start()
            try:
                deadline = time.monotonic() + 30
                while not await kv.put(b"\xf0-native", b"v"):
                    assert time.monotonic() < deadline
                    await asyncio.sleep(0.2)
                return await kv.get(b"\xf0-native")
            finally:
                await kv.shutdown()
                await t.close()

        assert asyncio.run(put_get()) == b"v"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        drained = [ln for ln in out.splitlines()
                   if ln.startswith("DRAINED ")]
        assert drained and json.loads(drained[0][8:])["clean"]
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    store_dir = ep.replace(":", "_")
    assert any((tmp_path / f"kv_{store_dir}").iterdir())
    assert (tmp_path / store_dir / "mlog").is_dir()
    assert (tmp_path / store_dir / "meta").is_dir()


def test_server_refuses_the_native_transport(tmp_path):
    """The server copy serves ``--transport native`` (it refused the C++
    epoll transport until the port carried it): a one-store cluster on
    the CPU timer plane, over the native transport and the native
    storage, takes a write from the port's native client, answers the
    pure-Python TCP client on the same port, and drains on SIGTERM."""
    import json
    import signal
    import threading

    from tpuraft_torch.rheakv.native_store import ensure_built
    from tpuraft_torch.rpc import native_tcp

    ensure_built()  # the server opens the KV engine without building it
    native_tcp.ensure_built()
    ep = free_endpoint()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuraft_torch.examples.rheakv_server",
         "--serve", ep, "--stores", ep, "--regions", "2",
         "--data", str(tmp_path), "--transport", "native",
         "--store", "native", "--log-scheme", "multilog", "--eto-ms",
         "300"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # a server that hangs before READY must not hang the test's readline
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), (line, proc.stderr.read()
                                           if proc.poll() is not None
                                           else "")

        async def put_get():
            from tpuraft_torch.examples.rheakv_server import client_for
            from tpuraft_torch.rpc.tcp import TcpTransport

            got = []
            for t in (native_tcp.NativeTcpTransport(), TcpTransport()):
                kv = client_for([ep], 2, transport=t)
                await kv.start()
                try:
                    deadline = time.monotonic() + 30
                    while not await kv.put(b"\xf0-wire", b"v"):
                        assert time.monotonic() < deadline
                        await asyncio.sleep(0.2)
                    got.append(await kv.get(b"\xf0-wire"))
                finally:
                    await kv.shutdown()
                    await t.close()
            return got

        assert asyncio.run(put_get()) == [b"v", b"v"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        drained = [ln for ln in out.splitlines()
                   if ln.startswith("DRAINED ")]
        assert drained and json.loads(drained[0][8:])["clean"]
        assert proc.returncode == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


async def test_multilog_scheme_is_refused(tmp_path):
    """log_scheme="multilog" (refused until the port carried the shared
    journal) puts every region of a store on one multilog engine and one
    multimeta journal, and a write commits through them."""
    from tpuraft_torch.storage.meta_multilog import MultiRaftMetaStorage
    from tpuraft_torch.storage.multilog import MultiLogStorage

    c = KVTestCluster(1, tmp_path=tmp_path, log_scheme="multilog",
                      regions=prefix_regions(2),
                      multi_raft_engine_factory=torch_engine(4),
                      store_opts={"disk_budget_bytes": DISK_BUDGET})
    try:
        await c.start_all()
        leaders = [await c.wait_region_leader(rid) for rid in (1, 2)]
        logs = [r.node.log_manager._storage for r in leaders]
        assert all(isinstance(lg, MultiLogStorage) for lg in logs)
        assert logs[0].engine is logs[1].engine
        assert all(isinstance(r.node._meta, MultiRaftMetaStorage)
                   for r in leaders)
        assert await leaders[1].raft_store.put(b"\xf0-ml", b"v")
        assert await leaders[1].raft_store.get(b"\xf0-ml") == b"v"
    finally:
        await c.stop_all()


def test_native_kv_engine_is_refused():
    """create_raw_kv_store (which refused ``native://`` until the port
    carried the C++ KV engine) opens the port's engine, built from and
    loaded out of tpuraft_torch/native."""
    import tempfile

    from tpuraft_torch.rheakv import create_raw_kv_store
    from tpuraft_torch.rheakv import native_store
    from tpuraft_torch.rheakv.raw_store import MemoryRawKVStore

    assert isinstance(create_raw_kv_store("memory://"), MemoryRawKVStore)
    with tempfile.TemporaryDirectory() as d:
        s = create_raw_kv_store(f"native://{d}/kv")
        try:
            assert isinstance(s, native_store.NativeRawKVStore)
            s.put(b"k", b"v")
            assert s.get(b"k") == b"v"
        finally:
            s.close()
    assert Path(native_store.lib_path()).resolve().parent == \
        ROOT / "tpuraft_torch" / "native"
    with pytest.raises(ValueError):
        create_raw_kv_store("rocksdb:///nowhere")
