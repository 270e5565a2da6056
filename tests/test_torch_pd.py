"""The port's placement driver and region lifecycle on the CPU.

- An exact differential: one seeded script of store and region
  heartbeats (delta rows, heat rows, occupancy), split reports and merge
  reports, acted on as a store would act on the instructions it gets,
  through both packages' PD FSM and PlacementEngine on one fake clock:
  the same instructions (split, merge, move, transfer) in the same order
  and byte-identical FSM snapshots.
- Port copies of the JAX package's ``tests/test_pd.py``,
  ``tests/test_region_lifecycle.py`` and the PD side of
  ``tests/test_heat.py`` (the cluster stats, hot-region detection and
  the cluster view) over a port PDTestCluster (the port's copy of
  ``tests/kv_cluster.py``'s).  The tests whose stores
  matter run twice: with every region node on its own timers, as the JAX
  package runs them, and with each store's regions driven by one port
  MultiRaftEngine ticking on the CPU, where splits mint engine groups,
  merges release them and moves run joint consensus through the tick's
  ``old_voter_mask`` lane.  The admin renderer test stays with
  ``examples/admin.py``, which the port has not copied yet.
"""

from __future__ import annotations

import asyncio
import contextlib
import struct
import time
import types
from typing import Optional

import numpy as np
import pytest

from tpuraft_torch.errors import RaftError
from tpuraft_torch.rheakv.client import RheaKVStore
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.pd_client import RemotePlacementDriverClient
from tpuraft_torch.rheakv.pd_server import (
    PlacementDriverOptions,
    PlacementDriverServer,
    RegionStats,
)
from tpuraft_torch.rheakv.placement import LifecycleOptions, PlacementEngine
from tpuraft_torch.rheakv.store_engine import StoreEngine, StoreEngineOptions
from tpuraft_torch.rpc.transport import InProcTransport, RpcServer

from tests.oracle import coverage_errors
from tests.test_torch_kv import DISK_BUDGET, KVTestCluster, torch_engine

# how the stores drive their region nodes
DRIVES = ["timers", "engine"]


def engine_kw(drive: str, backend: str = "torch") -> dict:
    """Cluster keywords for a drive: "engine" gives every store a port
    MultiRaftEngine on the CPU with headroom for splits."""
    if drive == "engine":
        return {"multi_raft_engine_factory": torch_engine(
            16, tick_interval_ms=10, backend=backend)}
    return {}


class PDTestCluster(KVTestCluster):
    """Port stores + a port PD raft cluster on the same loopback network
    (the port copy of ``tests/kv_cluster.py``'s PDTestCluster): stores
    heartbeat to the PD; the PD answers routing and emits split,
    transfer, merge and move instructions."""

    __test__ = False

    def __init__(self, n_stores: int = 3, n_pd: int = 3, tmp_path=None,
                 regions: Optional[list[Region]] = None,
                 election_timeout_ms: int = 300,
                 split_threshold_keys: int = 0,
                 heartbeat_interval_ms: int = 100,
                 balance_leaders: bool = False,
                 transfer_cooldown_s: float = 5.0,
                 pd_opts: Optional[dict] = None,
                 multi_raft_engine_factory=None):
        super().__init__(n_stores, tmp_path=tmp_path, regions=regions,
                         election_timeout_ms=election_timeout_ms,
                         multi_raft_engine_factory=multi_raft_engine_factory,
                         store_opts={"disk_budget_bytes": DISK_BUDGET})
        self.pd_endpoints = [f"127.0.0.1:{7000 + i}" for i in range(n_pd)]
        self.split_threshold_keys = split_threshold_keys
        self.heartbeat_interval_ms = heartbeat_interval_ms
        self.balance_leaders = balance_leaders
        self.transfer_cooldown_s = transfer_cooldown_s
        self.pd_opts = dict(pd_opts or {})
        self.pd_servers: dict[str, PlacementDriverServer] = {}

    async def start_all(self) -> None:
        for ep in self.pd_endpoints:
            await self.start_pd(ep)
        await super().start_all()

    async def start_pd(self, endpoint: str) -> PlacementDriverServer:
        server = RpcServer(endpoint)
        self.net.bind(server)
        self.net.start_endpoint(endpoint)
        transport = InProcTransport(self.net, endpoint)
        opts = PlacementDriverOptions(
            endpoints=list(self.pd_endpoints),
            election_timeout_ms=self.election_timeout_ms,
            data_path=str(self.tmp_path) if self.tmp_path else "",
            split_threshold_keys=self.split_threshold_keys,
            balance_leaders=self.balance_leaders,
            transfer_cooldown_s=self.transfer_cooldown_s,
            initial_regions=[r.copy() for r in self.region_template],
        )
        for k, v in self.pd_opts.items():
            setattr(opts, k, v)
        pd = PlacementDriverServer(opts, endpoint, server, transport)
        await pd.start()
        self.pd_servers[endpoint] = pd
        return pd

    async def stop_pd(self, endpoint: str) -> None:
        self.net.stop_endpoint(endpoint)
        pd = self.pd_servers.pop(endpoint, None)
        if pd:
            self.net.unbind(endpoint)
            await pd.shutdown()

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
            heartbeat_interval_ms=self.heartbeat_interval_ms,
        )
        for k, v in self.store_opts.items():
            setattr(opts, k, v)
        pd_client = RemotePlacementDriverClient(transport, self.pd_endpoints)
        engine = self.engine_factory() if self.engine_factory else None
        store = StoreEngine(opts, server, transport, multi_raft_engine=engine,
                            pd_client=pd_client)
        self.stores[endpoint] = store
        await store.start()
        return store

    async def stop_all(self) -> None:
        await super().stop_all()
        for ep in list(self.pd_servers):
            await self.stop_pd(ep)

    async def wait_pd_leader(self, timeout_s: float = 5.0
                             ) -> PlacementDriverServer:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            leaders = [p for p in self.pd_servers.values()
                       if p.node and p.node.is_leader()]
            if len(leaders) == 1:
                return leaders[0]
            await asyncio.sleep(0.02)
        raise TimeoutError("no PD leader")

    def pd_client(self, endpoint: str = "pdclient:0"
                  ) -> RemotePlacementDriverClient:
        return RemotePlacementDriverClient(
            InProcTransport(self.net, endpoint), self.pd_endpoints)


class JointTicks:
    """Counts, over every engine of a cluster, the ticks that ran with a
    group in a joint configuration (an ``old_voter_mask`` row set)."""

    def __init__(self, c):
        self.n = 0
        for s in c.stores.values():
            self.watch(s.multi_raft_engine)

    def watch(self, e) -> None:
        if e is None:
            return
        tick_once = e.tick_once

        def watched():
            if e.old_voter_mask.any():
                self.n += 1
            return tick_once()

        e.tick_once = watched


# -- the exact differential ------------------------------------------------------

class FakeClock:
    """The monotonic clock both packages' PD and placement policy read."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


def _pkg(name: str):
    if name == "jax":
        import tpuraft.rheakv.metadata as md
        import tpuraft.rheakv.pd_messages as pm
        import tpuraft.rheakv.pd_server as pds
        import tpuraft.rheakv.placement as pl
        import tpuraft.rpc.transport as tr
        import tpuraft.util.heat as heat
    else:
        import tpuraft_torch.rheakv.metadata as md
        import tpuraft_torch.rheakv.pd_messages as pm
        import tpuraft_torch.rheakv.pd_server as pds
        import tpuraft_torch.rheakv.placement as pl
        import tpuraft_torch.rpc.transport as tr
        import tpuraft_torch.util.heat as heat
    return types.SimpleNamespace(md=md, pm=pm, pds=pds, pl=pl, tr=tr,
                                 heat=heat)


STORES = [f"127.0.0.1:{9001 + i}" for i in range(4)]
SPACE = 1 << 16


def _key(x: int) -> bytes:
    return b"" if x in (0, SPACE) else struct.pack(">H", x)


class World:
    """The stores' side of the script: the regions, their leaders and
    sizes, changed only by the seeded load and by acting on the PD's
    instructions as a store would."""

    def __init__(self, md, n_regions: int):
        self.md = md
        self.bounds = {}   # rid -> [lo, hi)
        self.regions = {}
        self.leaders = {}
        self.keys = {}
        step = SPACE // n_regions
        for k in range(n_regions):
            rid = k + 1
            lo, hi = k * step, SPACE if k == n_regions - 1 else (k + 1) * step
            self.bounds[rid] = [lo, hi]
            self.regions[rid] = md.Region(
                id=rid, start_key=_key(lo), end_key=_key(hi),
                peers=list(STORES[:3]))   # the fourth store hosts nothing
            self.leaders[rid] = STORES[k % 3]
            self.keys[rid] = 20

    def region(self, rid):
        r = self.regions[rid]
        lo, hi = self.bounds[rid]
        r.start_key, r.end_key = _key(lo), _key(hi)
        return r


async def _run_pd_script(pkg, clock, seed: int, rounds: int = 48):
    """Drive one package's single-member PD through the script; returns
    (instruction log, FSM snapshot bytes, counters)."""
    md, pm, pds = pkg.md, pkg.pm, pkg.pds
    net = pkg.tr.InProcNetwork()
    ep = "127.0.0.1:7999"
    server = pkg.tr.RpcServer(ep)
    net.bind(server)
    net.start_endpoint(ep)
    pd = pds.PlacementDriverServer(pds.PlacementDriverOptions(
        endpoints=[ep], election_timeout_ms=300,
        split_threshold_keys=400, balance_leaders=True,
        transfer_cooldown_s=3.0, lifecycle=True,
        lifecycle_heat_split_min_keys=32,
        lifecycle_merge_cooldown_s=2.0, lifecycle_min_regions=6,
        lifecycle_move_cooldown_s=2.0, lifecycle_move_imbalance=2),
        ep, server, pkg.tr.InProcTransport(net, ep))
    await pd.start()
    try:
        deadline = time.monotonic() + 10
        while not (pd.node is not None and pd.node.is_leader()):
            assert time.monotonic() < deadline, "PD never elected"
            await asyncio.sleep(0.02)
        rng = np.random.default_rng(seed)
        w = World(md, 12)
        log, full = [], {s: True for s in STORES}
        Ins = pm.Instruction

        async def act(store, ins_blobs):
            for blob in ins_blobs:
                ins = Ins.decode(blob)
                log.append((store, ins.kind, ins.region_id,
                            ins.new_region_id, ins.target_peer,
                            ins.src_peer))
                rid = ins.region_id
                if rid not in w.regions:
                    continue
                if ins.kind == Ins.KIND_SPLIT:
                    child = ins.new_region_id
                    lo, hi = w.bounds[rid]
                    if child in w.regions or hi - lo < 2:
                        continue
                    mid = (lo + hi) // 2
                    parent = w.regions[rid]
                    parent.epoch.version += 1
                    w.bounds[rid] = [lo, mid]
                    w.bounds[child] = [mid, hi]
                    w.regions[child] = md.Region(
                        id=child, epoch=parent.epoch.copy(),
                        peers=list(parent.peers))
                    w.leaders[child] = w.leaders[rid]
                    w.keys[child] = w.keys[rid] // 2
                    w.keys[rid] -= w.keys[child]
                    resp = await pd._report_split(pm.ReportSplitRequest(
                        parent=w.region(rid).encode(),
                        child=w.region(child).encode()))
                    log.append(("split_report", resp.success))
                elif ins.kind == Ins.KIND_MERGE:
                    tgt = ins.new_region_id
                    if tgt not in w.regions or \
                            w.bounds[rid][1] != w.bounds[tgt][0]:
                        continue
                    w.bounds[tgt][0] = w.bounds[rid][0]
                    w.regions[tgt].epoch.version += 1
                    w.keys[tgt] += w.keys[rid]
                    for d in (w.regions, w.bounds, w.leaders, w.keys):
                        d.pop(rid)
                    resp = await pd._report_merge(pm.ReportMergeRequest(
                        source_region_id=rid, target_region_id=tgt))
                    log.append(("merge_report", resp.success))
                elif ins.kind == Ins.KIND_MOVE:
                    r = w.regions[rid]
                    if ins.src_peer not in r.peers or \
                            ins.target_peer in r.peers:
                        continue
                    r.peers[r.peers.index(ins.src_peer)] = ins.target_peer
                    r.epoch.conf_ver += 1
                    if w.leaders[rid] == ins.src_peer:
                        w.leaders[rid] = next(p for p in r.peers
                                              if p != ins.src_peer)
                elif ins.kind == Ins.KIND_TRANSFER_LEADER:
                    if ins.target_peer in w.regions[rid].peers:
                        w.leaders[rid] = ins.target_peer

        for rnd in range(rounds):
            clock.t += float(rng.uniform(0.4, 1.2))
            # the hot set shifts halfway through; hot regions take keys
            ids = sorted(w.regions)
            hot = set(ids[:3] if rnd < rounds // 2 else ids[-3:])
            for rid in ids:
                w.keys[rid] += int(rng.integers(20, 60)) if rid in hot \
                    else int(rng.integers(0, 2))
            for i, store in enumerate(STORES):
                led = [rid for rid in sorted(w.regions)
                       if w.leaders[rid] == store]
                heat = [(rid, float(rng.uniform(200, 400)),
                         float(rng.uniform(50, 100)), 4096.0, 1024.0)
                        if rid in hot else
                        (rid, 0.0, 0.0, 0.0, 0.0) for rid in led]
                hosted = sum(store in r.peers for r in w.regions.values())
                req = pm.StoreHeartbeatBatchRequest(
                    store_id=i + 1, endpoint=store,
                    deltas=[pm.encode_region_delta(
                        w.region(rid).encode(), store, w.keys[rid])
                        for rid in led],
                    full=full[store],
                    heat=pkg.heat.encode_heat_rows(heat),
                    replicas=hosted,
                    replicas_quiescent=hosted - len(led))
                resp = await pd._store_heartbeat_batch(req)
                full[store] = resp.need_full
                log.append(("batch", store, resp.need_full))
                await act(store, resp.instructions)
            # one legacy per-region heartbeat a round
            rid = int(rng.choice(sorted(w.regions)))
            resp = await pd._region_heartbeat(pm.RegionHeartbeatRequest(
                region=w.region(rid).encode(), leader=w.leaders[rid],
                approximate_keys=w.keys[rid]))
            await act(w.leaders[rid], resp.instructions)
        snap = {}

        class Writer:
            def write_file(self, name, data):
                snap[name] = bytes(data)

        await pd.fsm.on_snapshot_save(Writer(), lambda st: None)
        counters = {k: getattr(pd, k) for k in (
            "splits_ordered", "transfers_ordered", "heat_splits_ordered",
            "merges_ordered", "merges_completed", "moves_ordered",
            "hb_batch_rpcs", "hb_delta_rows", "hb_heat_rows")}
        counters["coverage"] = coverage_errors(pd.fsm.regions.values())
        return log, snap["pd_meta"], counters
    finally:
        await pd.shutdown()
        net.unbind(ep)


@pytest.mark.parametrize("seed", [0, 1])
async def test_pd_script_matches_jax_pd(monkeypatch, seed):
    """The same seeded heartbeat script through both packages' PD: the
    same instructions in the same order, the same counters and
    byte-identical FSM snapshots; the script reaches every kind of
    instruction."""
    clock = FakeClock()
    out = {}
    for name in ("jax", "torch"):
        pkg = _pkg(name)
        monkeypatch.setattr(pkg.pds, "time", clock)
        monkeypatch.setattr(pkg.pl, "time", clock)
        clock.t = 1000.0
        out[name] = await _run_pd_script(pkg, clock, seed)
    (jlog, jsnap, jcnt), (tlog, tsnap, tcnt) = out["jax"], out["torch"]
    assert tlog == jlog
    assert tcnt == jcnt
    assert tsnap == jsnap
    Ins = _pkg("torch").pm.Instruction
    kinds = {e[1] for e in tlog if isinstance(e[1], int)}
    assert kinds >= {Ins.KIND_SPLIT, Ins.KIND_MERGE, Ins.KIND_MOVE,
                     Ins.KIND_TRANSFER_LEADER}, kinds
    assert tcnt["heat_splits_ordered"] > 0 and tcnt["merges_completed"] > 0
    assert tcnt["coverage"] == []


@pytest.mark.parametrize("n", [1, 2, 4, 10, 16, 64, 1024])
def test_pd_server_seeds_the_regions_of_the_jax_package(n):
    """The PD server copy takes make_regions from the server copy (the
    original imports it from examples/rheakv_bench.py, which loads the
    JAX package): the same --seed-regions layout, region for region."""
    from examples.rheakv_bench import make_regions as jax_make_regions
    from tpuraft_torch.examples import pd_server

    got = [r.encode() for r in pd_server.make_regions(n)]
    assert got == [r.encode() for r in jax_make_regions(n)]


# -- port copies of tests/test_pd.py --------------------------------------------

@contextlib.asynccontextmanager
async def pd_cluster(**kw):
    c = PDTestCluster(**kw)
    await c.start_all()
    try:
        yield c
    finally:
        await c.stop_all()


async def test_legacy_batch_fallback_decomposes_and_requests_full():
    """The legacy (pre-batch / PD-less) store_heartbeat_batch fallback
    decomposes deltas into per-region heartbeats AND answers
    need_full=True, so every store round carries every led region."""
    from tpuraft_torch.rheakv.metadata import StoreMeta
    from tpuraft_torch.rheakv.pd_client import PlacementDriverClient

    class Recorder(PlacementDriverClient):
        def __init__(self):
            self.store_rounds = []
            self.region_reports = []

        async def store_heartbeat(self, meta):
            self.store_rounds.append([r.id for r in meta.regions])

        async def region_heartbeat(self, region, leader, metrics=None):
            self.region_reports.append(
                (region.id, leader, (metrics or {}).get("approximate_keys")))
            return [("split-order", region.id)]

    pd = Recorder()
    regions = [Region(id=i, start_key=bytes([i]), end_key=bytes([i + 1]))
               for i in (1, 2, 3)]
    meta = StoreMeta(id=7, endpoint="127.0.0.1:9001", regions=[])
    instructions, need_full = await pd.store_heartbeat_batch(
        meta, [(r, "127.0.0.1:9001", 10 * r.id) for r in regions])
    assert need_full, "legacy fallback must force full rounds"
    assert pd.store_rounds == [[1, 2, 3]]
    assert pd.region_reports == [(1, "127.0.0.1:9001", 10),
                                 (2, "127.0.0.1:9001", 20),
                                 (3, "127.0.0.1:9001", 30)]
    assert instructions == [("split-order", 1), ("split-order", 2),
                            ("split-order", 3)]


@pytest.mark.parametrize("drive", DRIVES)
async def test_pd_tracks_stores_and_regions(drive):
    async with pd_cluster(**engine_kw(drive)) as c:
        await c.wait_pd_leader()
        pd = c.pd_client()
        deadline = time.monotonic() + 5
        stores, regions = [], []
        while time.monotonic() < deadline:
            stores = await pd.get_store_metas()
            regions = await pd.list_regions()
            if len(stores) == 3 and len(regions) >= 1:
                break
            await asyncio.sleep(0.1)
        assert len(stores) == 3
        assert {s.endpoint for s in stores} == set(c.endpoints)
        assert any(r.id == 1 for r in regions)


async def test_pd_region_id_allocation():
    async with pd_cluster() as c:
        await c.wait_pd_leader()
        from tpuraft_torch.rheakv.pd_messages import CreateRegionIdRequest

        pd = c.pd_client()
        r1 = await pd._call("pd_create_region_id", CreateRegionIdRequest())
        r2 = await pd._call("pd_create_region_id", CreateRegionIdRequest())
        assert r2.region_id == r1.region_id + 1 >= 1024


@pytest.mark.parametrize("drive", DRIVES)
async def test_pd_leader_failover(drive):
    async with pd_cluster(**engine_kw(drive)) as c:
        leader = await c.wait_pd_leader()
        pd = c.pd_client()
        assert await pd.list_regions() is not None
        await c.stop_pd(leader.server_id.endpoint)
        await c.wait_pd_leader()
        regions = await pd.list_regions()
        assert any(r.id == 1 for r in regions)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if len(await pd.get_store_metas()) == 3:
                break
            await asyncio.sleep(0.1)
        assert len(await pd.get_store_metas()) == 3


@pytest.mark.parametrize("drive", DRIVES)
async def test_pd_ordered_auto_split(drive):
    """Write past the threshold; the PD orders a split on heartbeat."""
    async with pd_cluster(split_threshold_keys=24, **engine_kw(drive)) as c:
        await c.wait_pd_leader()
        leader = await c.wait_region_leader(1)
        rs = leader.raft_store
        for i in range(40):
            await rs.put(b"auto%03d" % i, b"v")
        await c.wait_region_on_all(1024, timeout_s=10)
        l2 = await c.wait_region_leader(1024)
        assert l2.region.start_key != b""
        pd = c.pd_client()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            regions = await pd.list_regions()
            if len(regions) >= 2:
                break
            await asyncio.sleep(0.1)
        assert len(regions) >= 2
        if drive == "engine":  # the child is a group of every engine
            for s in c.stores.values():
                assert s.multi_raft_engine._n_ctrls == 2


async def test_split_decision_survives_pd_failover():
    """The split DECISION is replicated PD state: order a split, kill the
    PD leader before the store reports completion — the new leader
    re-issues the SAME child region id, never a duplicate."""
    from tpuraft_torch.rheakv.metadata import RegionEpoch
    from tpuraft_torch.rheakv.pd_messages import (Instruction,
                                                  RegionHeartbeatRequest,
                                                  ReportSplitRequest)

    async with pd_cluster(split_threshold_keys=1000) as c:
        leader = await c.wait_pd_leader()
        region = Region(id=7, start_key=b"", end_key=b"",
                        peers=list(c.endpoints),
                        epoch=RegionEpoch(1, 1))

        async def beat(keys: int) -> list:
            for srv in list(c.pd_servers.values()):
                node = srv.node
                if node is not None and node.is_leader():
                    resp = await srv._region_heartbeat(
                        RegionHeartbeatRequest(
                            region=region.encode(),
                            leader=c.endpoints[0],
                            approximate_keys=keys))
                    return [Instruction.decode(b)
                            for b in resp.instructions]
            return []

        ins = await beat(5000)
        assert len(ins) == 1 and ins[0].kind == Instruction.KIND_SPLIT
        child_id = ins[0].new_region_id
        assert child_id >= 1024
        assert leader.fsm.pending_splits.get(7) == child_id
        await c.stop_pd(leader.server_id.endpoint)
        new_leader = await c.wait_pd_leader()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and \
                new_leader.fsm.pending_splits.get(7) != child_id:
            await asyncio.sleep(0.05)
        assert new_leader.fsm.pending_splits.get(7) == child_id
        ids = set()
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline and not ids:
            for i in await beat(5000):
                if i.kind == Instruction.KIND_SPLIT:
                    ids.add(i.new_region_id)
            await asyncio.sleep(0.2)
        assert ids == {child_id}, ids
        parent_done = Region(id=7, start_key=b"", end_key=b"m",
                             peers=list(c.endpoints),
                             epoch=RegionEpoch(1, 2))
        child_done = Region(id=child_id, start_key=b"m", end_key=b"",
                            peers=list(c.endpoints),
                            epoch=RegionEpoch(1, 2))
        for srv in list(c.pd_servers.values()):
            node = srv.node
            if node is not None and node.is_leader():
                await srv._report_split(ReportSplitRequest(
                    parent=parent_done.encode(), child=child_done.encode()))
        assert new_leader.fsm.pending_splits.get(7) is None


@pytest.mark.parametrize("drive", DRIVES)
async def test_client_with_remote_pd(drive):
    async with pd_cluster(**engine_kw(drive)) as c:
        await c.wait_pd_leader()
        await c.wait_region_leader(1)
        kv = RheaKVStore(c.pd_client(), c.client_transport())
        await kv.start()
        assert await kv.put(b"via-pd", b"yes")
        assert await kv.get(b"via-pd") == b"yes"
        s = await kv.get_sequence(b"pd-seq", 5)
        assert (s.start, s.end) == (0, 5)
        await kv.shutdown()


@pytest.mark.parametrize("drive", DRIVES)
async def test_pd_balances_leaders(drive):
    """All regions' leaders piled onto one store get TRANSFER_LEADER
    instructions until counts even out, without oscillating."""
    regions = [Region(id=i + 1,
                      start_key=bytes([i * 40]) if i else b"",
                      end_key=bytes([(i + 1) * 40]) if i < 5 else b"")
               for i in range(6)]
    async with pd_cluster(regions=regions, balance_leaders=True,
                          transfer_cooldown_s=1.5, **engine_kw(drive)) as c:
        def leader_counts():
            counts = {ep: 0 for ep in c.endpoints}
            for rid in range(1, 7):
                for ep, s in c.stores.items():
                    eng = s.get_region_engine(rid)
                    if eng is not None and eng.is_leader():
                        counts[ep] += 1
            return counts

        await c.wait_pd_leader()
        for rid in range(1, 7):
            await c.wait_region_leader(rid)
        target = c.endpoints[0]
        from tpuraft_torch.entity import PeerId

        for rid in range(1, 7):
            for _ in range(4):
                leader = await c.wait_region_leader(rid)
                if leader.store_engine.server_id.endpoint == target:
                    break
                await leader.transfer_leadership_to(PeerId.parse(target))
                await asyncio.sleep(0.2)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            leader0 = sum(
                1 for rid in range(1, 7)
                for s in [c.stores[target].get_region_engine(rid)]
                if s is not None and s.is_leader())
            if leader0 >= 5:
                break
            await asyncio.sleep(0.1)
        deadline = time.monotonic() + 45
        spread = None
        trajectory = []
        counts = {}
        while time.monotonic() < deadline:
            counts = leader_counts()
            spread = max(counts.values()) - min(counts.values())
            if not trajectory or trajectory[-1][1] != counts:
                trajectory.append((round(time.monotonic() - deadline + 45, 1),
                                   dict(counts)))
            if sum(counts.values()) == 6 and spread <= 2:
                break
            await asyncio.sleep(0.2)
        assert spread is not None and spread <= 2, \
            f"final={counts} trajectory={trajectory}"
        worst = 0
        samples = 0
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5:
            counts = leader_counts()
            if sum(counts.values()) == 6:
                samples += 1
                worst = max(worst, max(counts.values()) - min(counts.values()))
            await asyncio.sleep(0.2)
        assert samples > 0, "no fully-led sample in the stability window"
        assert worst <= 2, f"balancer thrashing: worst spread {worst}"


async def test_balancer_cooldown_survives_pd_failover():
    """Transfer cooldowns are leader-local, so the new PD leader rebuilds
    them on takeover: a region transferred just before the failover is
    never immediately re-transferred, and balancing resumes after one
    cooldown.

    No store runs here, unlike the JAX package's copy: a store
    heartbeating from ep0 gets the policy pass over the regions the PD
    thinks it leads, so it can take the ordered transfer in its own
    response and leave the test's beats the cooldown (a race the loaded
    CPU loses often enough to fail the test)."""
    from tpuraft_torch.rheakv.metadata import RegionEpoch
    from tpuraft_torch.rheakv.pd_messages import (Instruction,
                                                  RegionHeartbeatRequest)

    cooldown_s = 3.0
    async with pd_cluster(n_stores=0, balance_leaders=True,
                          transfer_cooldown_s=cooldown_s) as c:
        await c.wait_pd_leader()
        peers = [f"127.0.0.1:{6000 + i}" for i in range(3)]
        regions = {
            rid: Region(id=rid, start_key=b"", end_key=b"",
                        peers=list(peers), epoch=RegionEpoch(1, 1))
            for rid in (41, 42, 43, 44)}
        ep0 = peers[0]

        async def beat(rid: int, leader_ep: str) -> list:
            for srv in list(c.pd_servers.values()):
                node = srv.node
                if node is not None and node.is_leader():
                    resp = await srv._region_heartbeat(
                        RegionHeartbeatRequest(
                            region=regions[rid].encode(),
                            leader=leader_ep, approximate_keys=1))
                    return [Instruction.decode(b)
                            for b in resp.instructions]
            return []

        async def beat_until_transfer(budget_s: float):
            deadline = time.monotonic() + budget_s
            while time.monotonic() < deadline:
                for rid in regions:
                    for i in await beat(rid, ep0):
                        if i.kind == Instruction.KIND_TRANSFER_LEADER:
                            return (rid, i.target_peer)
                await asyncio.sleep(min(0.1, cooldown_s / 20))
            return None

        ordered = await beat_until_transfer(6 * cooldown_s + 10)
        assert ordered is not None, "balancer never ordered a transfer"
        leader = await c.wait_pd_leader()
        await c.stop_pd(leader.server_id.endpoint)
        await c.wait_pd_leader()
        t0 = time.monotonic()
        checked_rounds = 0
        while time.monotonic() - t0 < 0.5 * cooldown_s:
            round_ins = []
            for rid in regions:
                round_ins.append((rid, await beat(rid, ep0)))
            if time.monotonic() - t0 >= 0.5 * cooldown_s:
                break  # this round overran the safe window: inconclusive
            for rid, ins in round_ins:
                kinds = [i.kind for i in ins]
                assert Instruction.KIND_TRANSFER_LEADER not in kinds, \
                    f"immediate re-transfer of region {rid} after failover"
            checked_rounds += 1
            await asyncio.sleep(min(0.2, cooldown_s / 15))
        assert checked_rounds > 0, \
            "host too slow to observe the grace window at all"
        resumed = await beat_until_transfer(6 * cooldown_s + 10)
        assert resumed is not None, \
            "balancer never resumed after the grace window"


# -- port copies of tests/test_heat.py's PD side ---------------------------------

def _stats(threshold=0):
    from tpuraft_torch.rheakv.pd_server import ClusterStatsManager

    return ClusterStatsManager(split_threshold_keys=threshold)


def test_cluster_stats_unified_intake():
    """One region-stats record: the split policy reads keys and the view
    reads heat from the same entry; a split resets keys, not heat."""
    s = _stats(threshold=100)
    s.record(1, 150)
    s.record_heat(1, 10.0, 5.0, 0.0, 0.0)
    ent = s.region_stats(1)
    assert ent.keys == 150 and ent.writes_s == 10.0
    assert s.last_keys(1) == 150
    assert s.should_split(1)
    s.mark_split_issued(1)
    assert s.last_keys(1) == 0
    assert s.region_stats(1).writes_s == 10.0


def test_cluster_stats_top_hot_and_cold():
    s = _stats()
    s.record_heat(1, 1.0, 0.0, 0.0, 0.0)
    s.record_heat(2, 50.0, 0.0, 0.0, 0.0)
    s.record(3, 10)  # keys only: zero heat
    assert [rid for rid, _ in s.top_hot(8)] == [2, 1]   # zero-score excluded
    assert [rid for rid, _ in s.top_cold(1)] == [3]


def test_hot_region_detection_fires_recorder_with_hysteresis(monkeypatch):
    from tpuraft_torch.util.trace import RECORDER

    # the recorder coalesces a (kind, region) within a second: start from
    # clean windows, since the PD differential in this process flags
    # region 1 hot too
    monkeypatch.setattr(RECORDER, "_coalesce", {})
    s = _stats()
    s.hot_min_score = 5.0
    s.hot_factor = 2.0
    for rid in range(10, 30):   # background fleet: 20 cool regions
        s.record_heat(rid, 0.5, 0.0, 0.0, 0.0)
    s._hot_recalc_at = 0.0  # sweep now sees the full population
    s.record_heat(1, 100.0, 0.0, 0.0, 0.0)
    assert 1 in s.hot_regions()
    assert s.hot_events == 1
    evs = [e for e in RECORDER.events()
           if e[1] == "hot_region" and e[2] == "1"]
    assert evs and evs[-1][3]["score"] == pytest.approx(100.0)
    s.record_heat(1, 110.0, 0.0, 0.0, 0.0)   # staying hot: no re-fire
    assert s.hot_events == 1
    # hysteresis: cools only below half the threshold
    s._hot_recalc_at = 0.0
    s.record_heat(1, s._hot_threshold * 0.75, 0.0, 0.0, 0.0)
    assert 1 in s.hot_regions()
    s.record_heat(1, 0.1, 0.0, 0.0, 0.0)
    assert 1 not in s.hot_regions()


def test_hot_detection_bootstrap_and_small_fleet_shape():
    """A half-reported bootstrap fleet does not mass-flag, and in a small
    fleet the hot set flags against the background median."""
    s = _stats()
    for rid in range(4):
        s.record_heat(rid, 50.0, 0.0, 0.0, 0.0)
    assert s.hot_regions() == set()
    assert s.hot_events == 0
    for rid in range(24):
        s.record_heat(rid, 10.0, 0.0, 0.0, 0.0)
    s._hot_recalc_at = 0.0
    for rid in (1, 5, 9):
        s.record_heat(rid, 300.0, 0.0, 0.0, 0.0)
    assert s.hot_regions() == {1, 5, 9}
    assert s.hot_events == 3


def test_hot_sweep_zeroes_stale_rates_and_cools_silent_regions():
    """The sweep zeroes rates older than heat_stale_s and re-judges
    flagged regions without waiting for an intake row; keys survive."""
    s = _stats()
    for rid in range(12):
        s.record_heat(rid, 10.0, 0.0, 0.0, 0.0)
    s._hot_recalc_at = 0.0
    s.record_heat(3, 500.0, 0.0, 0.0, 0.0)
    assert 3 in s.hot_regions()
    past = time.monotonic() - (s.heat_stale_s + 1.0)
    for rid in range(12):
        s._stats[rid].heat_at = past
    s._hot_recalc_at = 0.0
    s.maybe_sweep()
    assert all(s.region_stats(r).writes_s == 0.0 for r in range(12))
    assert s.hot_regions() == set()
    s.record(5, 77)
    s._stats[5].heat_at = past
    s._hot_recalc_at = 0.0
    s.maybe_sweep()
    assert s.last_keys(5) == 77


def test_hot_flags_survive_population_dip():
    """A reporter dropout below the population gate neither erases live
    flags nor admits new ones."""
    s = _stats()
    for rid in range(12):
        s.record_heat(rid, 10.0, 0.0, 0.0, 0.0)
    s._hot_recalc_at = 0.0
    s.record_heat(3, 500.0, 0.0, 0.0, 0.0)
    assert 3 in s.hot_regions()
    events_before = s.hot_events
    past = time.monotonic() - (s.heat_stale_s + 1.0)
    for rid in range(12):
        if rid not in (1, 2, 3):
            s._stats[rid].heat_at = past
    s._hot_recalc_at = 0.0
    s.maybe_sweep()
    assert s._hot_threshold is None
    assert 3 in s.hot_regions()
    s.record_heat(2, 400.0, 0.0, 0.0, 0.0)
    assert 2 not in s.hot_regions()
    s.record_heat(3, 450.0, 0.0, 0.0, 0.0)
    assert 3 in s.hot_regions()
    assert s.hot_events == events_before


async def test_pd_cluster_view_over_wire(tmp_path):
    """Heat rows and occupancy ride the heartbeat into the PD; the
    pd_cluster_describe RPC serves the folded view, and the PD's
    Prometheus text the same aggregates."""
    from tpuraft_torch.rheakv.pd_messages import (StoreHeartbeatBatchRequest,
                                                  encode_region_delta)
    from tpuraft_torch.util.heat import encode_heat_rows

    c = PDTestCluster(n_stores=0, n_pd=1, tmp_path=tmp_path)
    for ep in c.pd_endpoints:
        await c.start_pd(ep)
    try:
        await c.wait_pd_leader()
        pd_client = c.pd_client()
        r1 = Region(id=1, start_key=b"", end_key=b"m",
                    peers=["127.0.0.1:9001"])
        r2 = Region(id=2, start_key=b"m", end_key=b"",
                    peers=["127.0.0.1:9001"])
        req = StoreHeartbeatBatchRequest(
            store_id=1, endpoint="127.0.0.1:9001",
            deltas=[encode_region_delta(r.encode(), "127.0.0.1:9001", 10)
                    for r in (r1, r2)],
            full=True, zone="z-east", health="healthy",
            heat=encode_heat_rows([(1, 40.0, 10.0, 0.0, 0.0),
                                   (2, 1.0, 0.0, 0.0, 0.0)]),
            replicas=8, replicas_quiescent=6)
        resp = await pd_client._call("pd_store_heartbeat_batch", req)
        assert resp.success
        view = await pd_client.cluster_describe(top_k=2)
        assert view is not None
        assert view["regions"] == 2
        assert [r["region"] for r in view["hot"]] == [1, 2]
        assert view["hot"][0]["writes_s"] == pytest.approx(40.0)
        assert view["hot"][0]["keys"] == 10
        assert view["zone_rates"]["z-east"]["writes_s"] == \
            pytest.approx(41.0)
        assert view["hibernation"] == {
            "replicas": 8, "quiescent": 6, "fraction": 0.75}
        store_row = view["stores"][0]
        assert store_row["zone"] == "z-east"
        assert store_row["replicas_quiescent"] == 6
        pd = await c.wait_pd_leader()
        text = pd.metrics_text()
        assert "tpuraft_pd_hb_heat_rows" in text
        assert "tpuraft_pd_hibernation_fraction" in text
        assert "tpuraft_pd_regions" in text
    finally:
        await c.stop_all()


# -- port copies of tests/test_region_lifecycle.py -----------------------------

def _r(rid, start, end):
    return Region(id=rid, start_key=start, end_key=end)


def test_coverage_oracle_accepts_tiling():
    """The port's keyspace oracle (rheakv/keyspace.py) accepts tilings,
    as the JAX package's does."""
    from tpuraft_torch.rheakv.keyspace import coverage_errors as port_cov

    for cov in (coverage_errors, port_cov):
        assert cov([_r(1, b"", b"")]) == []
        assert cov([_r(1, b"", b"m"), _r(2, b"m", b"")]) == []
        assert cov(
            [_r(3, b"g", b"t"), _r(1, b"", b"g"), _r(2, b"t", b"")]) == []


def test_coverage_oracle_flags_violations():
    from tpuraft_torch.rheakv.keyspace import coverage_errors as port_cov

    cases = [[], [_r(1, b"a", b"")], [_r(1, b"", b"g"), _r(2, b"h", b"")],
             [_r(1, b"", b"z")], [_r(1, b"", b"m"), _r(2, b"g", b"")],
             [_r(1, b"", b""), _r(2, b"m", b"")],
             [_r(1, b"", b"m"), _r(1, b"m", b"")]]
    for case in cases:  # the same verdict as the JAX package's
        assert port_cov(case) == coverage_errors(case)
    assert port_cov([]) != []
    assert any("hole" in e for e in port_cov([_r(1, b"a", b"")]))
    assert any("hole" in e for e in port_cov(
        [_r(1, b"", b"g"), _r(2, b"h", b"")]))
    assert any("hole" in e for e in port_cov([_r(1, b"", b"z")]))
    assert any("overlap" in e for e in port_cov(
        [_r(1, b"", b"m"), _r(2, b"g", b"")]))
    assert any("unbounded" in e for e in port_cov(
        [_r(1, b"", b""), _r(2, b"m", b"")]))
    assert any("twice" in e for e in port_cov(
        [_r(1, b"", b"m"), _r(1, b"m", b"")]))


EP = ["127.0.0.1:6%03d" % i for i in range(4)]


class _StatsStub:
    """Duck-typed ClusterStatsManager slice the policy reads."""

    def __init__(self, stats=None, hot=()):
        self._stats = dict(stats or {})
        self._hot = set(hot)

    def hot_regions(self):
        return set(self._hot)

    def region_stats(self, rid):
        return self._stats.get(rid) or RegionStats()

    def last_keys(self, rid):
        return self.region_stats(rid).keys


def _three_regions():
    peers = list(EP[:3])
    return {
        1: Region(id=1, start_key=b"", end_key=b"g", peers=list(peers)),
        2: Region(id=2, start_key=b"g", end_key=b"t", peers=list(peers)),
        3: Region(id=3, start_key=b"t", end_key=b"", peers=list(peers)),
    }


def test_pick_merge_cold_adjacent_pair_and_pacing():
    eng = PlacementEngine(LifecycleOptions(min_regions=2))
    regions = _three_regions()
    leaders = {rid: EP[0] for rid in regions}
    stats = _StatsStub({rid: RegionStats(keys=10) for rid in regions})
    pick = eng.pick_merge(regions, leaders, EP[0], stats, {}, {})
    assert pick == (1, 2)
    assert eng.pick_merge(regions, leaders, EP[0], stats, {}, {}) is None


def test_pick_merge_busy_and_floor_exclusions():
    regions = _three_regions()
    leaders = {rid: EP[0] for rid in regions}
    stats = _StatsStub({rid: RegionStats(keys=10) for rid in regions})

    def fresh():
        return PlacementEngine(LifecycleOptions(min_regions=2))

    assert fresh().pick_merge(regions, leaders, EP[0], stats,
                              {}, {1: 99}) == (2, 3)
    assert fresh().pick_merge(regions, leaders, EP[0], stats,
                              {}, {1: 99, 2: 98}) is None
    hot = _StatsStub({rid: RegionStats(keys=10) for rid in regions},
                     hot={1, 2})
    assert fresh().pick_merge(regions, leaders, EP[0], hot, {}, {}) is None
    eng = PlacementEngine(LifecycleOptions(min_regions=2,
                                           max_inflight_merges=1))
    assert eng.pick_merge(regions, leaders, EP[0], stats,
                          {7: 8}, {}) is None
    eng = PlacementEngine(LifecycleOptions(min_regions=3))
    assert eng.pick_merge(regions, leaders, EP[0], stats, {}, {}) is None
    assert fresh().pick_merge(regions, leaders, EP[1], stats, {}, {}) is None


def test_pick_merge_oversized_source_excluded():
    regions = _three_regions()
    leaders = {rid: EP[0] for rid in regions}
    stats = _StatsStub({1: RegionStats(keys=100000),
                        2: RegionStats(keys=10),
                        3: RegionStats(keys=10)})
    eng = PlacementEngine(LifecycleOptions(min_regions=2,
                                           merge_max_keys=4096))
    assert eng.pick_merge(regions, leaders, EP[0], stats, {}, {}) == (2, 3)


def test_pick_move_imbalance_zone_and_health():
    peers = list(EP[:3])
    regions = {i: Region(id=i, start_key=b"%d" % i, end_key=b"%d" % (i + 1),
                         peers=list(peers)) for i in range(1, 4)}
    leaders = {rid: EP[0] for rid in regions}
    eng = PlacementEngine(LifecycleOptions(move_imbalance=2))
    mv = eng.pick_move(regions, leaders, EP[0], EP, {}, {}, {}, {})
    assert mv is not None
    rid, src_p, dst_ep = mv
    assert dst_ep == EP[3]
    assert src_p != leaders[rid]
    eng2 = PlacementEngine(LifecycleOptions(move_imbalance=2,
                                            max_inflight_moves=1))
    assert eng2.pick_move(regions, leaders, EP[0], EP, {}, {}, {}, {})
    assert eng2.pick_move(regions, leaders, EP[0], EP, {}, {}, {}, {}) \
        is None
    eng3 = PlacementEngine(LifecycleOptions(move_imbalance=2))
    assert eng3.pick_move(regions, leaders, EP[0], EP, {},
                          {EP[3]: "sick"}, {}, {}) is None
    two = {i: Region(id=i, start_key=b"%d" % i, end_key=b"%d" % (i + 1),
                     peers=[EP[0], EP[1]]) for i in range(1, 4)}
    zones = {EP[0]: "z1", EP[1]: "z1", EP[2]: "z1", EP[3]: "z2"}
    eng4 = PlacementEngine(LifecycleOptions(move_imbalance=2))
    mv = eng4.pick_move(two, {rid: EP[0] for rid in two}, EP[0], EP,
                        zones, {}, {}, {})
    assert mv is not None and mv[2] == EP[3]


def test_pick_move_balanced_fleet_is_left_alone():
    regions = {1: Region(id=1, start_key=b"", end_key=b"",
                         peers=list(EP[:3]))}
    eng = PlacementEngine(LifecycleOptions(move_imbalance=2))
    assert eng.pick_move(regions, {1: EP[0]}, EP[0], EP[:3],
                         {}, {}, {}, {}) is None


@contextlib.asynccontextmanager
async def kv_cluster(n=3, regions=None, drive="timers", backend="torch",
                     **kw):
    c = KVTestCluster(n, regions=regions, **engine_kw(drive, backend), **kw)
    await c.start_all()
    try:
        yield c
    finally:
        await c.stop_all()


def _two_region_template():
    return [Region(id=1, start_key=b"", end_key=b"m"),
            Region(id=2, start_key=b"m", end_key=b"")]


async def _wait(cond, timeout_s=8.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        await asyncio.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {what}")


async def _absorbed_everywhere(c, rid: int, drive: str) -> None:
    """With engine-driven nodes a follower store learns the absorbing
    group's commit index on a later tick than the one that retired the
    source group there, so its copy of region `rid` extends over the
    merged keyspace a few ticks after the source is gone (12-35 ms seen
    on the CPU): wait for that before reading every store's copy.  On
    timers the copies are read at once, as the JAX package's test
    reads them."""
    if drive == "engine":
        await _wait(lambda: all(
            coverage_errors([s.get_region_engine(rid).region]) == []
            for s in c.stores.values()),
            what=f"region {rid}'s absorb applied on every store")


@pytest.mark.parametrize("drive", DRIVES)
async def test_merge_absorbs_keyspace_and_retires_source(drive):
    async with kv_cluster(regions=_two_region_template(), drive=drive) as c:
        l1 = await c.wait_region_leader(1)
        l2 = await c.wait_region_leader(2)
        for i in range(8):
            assert await l1.raft_store.put(b"a%02d" % i, b"L%d" % i)
            assert await l2.raft_store.put(b"z%02d" % i, b"R%d" % i)
        st = await l1.store_engine.apply_merge(
            1, 2, str(l2.node.server_id))
        assert st.is_ok(), str(st)
        await _wait(lambda: all(s.get_region_engine(1) is None
                                for s in c.stores.values()),
                    what="source retirement on all stores")
        await _absorbed_everywhere(c, 2, drive)
        for s in c.stores.values():
            r2 = s.get_region_engine(2).region
            assert (r2.start_key, r2.end_key) == (b"", b"")
            assert coverage_errors([r2]) == []
            assert s.regions_retired == 1 or s.regions_absorbed >= 0
        l2 = await c.wait_region_leader(2)
        assert await l2.raft_store.get(b"a03") == b"L3"
        assert await l2.raft_store.get(b"z03") == b"R3"
        assert await l2.raft_store.put(b"a99", b"post-merge")
        assert await l2.raft_store.get(b"a99") == b"post-merge"
        assert l1.store_engine.merges_led == 1
        if drive == "engine":  # the retired group left every engine
            await _wait(lambda: all(s.multi_raft_engine._n_ctrls == 1
                                    for s in c.stores.values()),
                        what="the retired group's engine row released")


@pytest.mark.parametrize("drive", DRIVES)
async def test_merge_defers_on_inflight_conf_change(drive):
    async with kv_cluster(regions=_two_region_template(), drive=drive) as c:
        l1 = await c.wait_region_leader(1)
        l2 = await c.wait_region_leader(2)
        tp = str(l2.node.server_id)
        l1.node._conf_ctx = object()
        try:
            st = await l1.store_engine.apply_merge(1, 2, tp)
            assert st.code == RaftError.EBUSY, str(st)
            assert getattr(l1.fsm, "sealed_into", -1) == -1
        finally:
            l1.node._conf_ctx = None
        st = await l1.store_engine.apply_merge(1, 2, tp)
        assert st.is_ok(), str(st)
        await _wait(lambda: all(s.get_region_engine(1) is None
                                for s in c.stores.values()),
                    what="deferred merge completion")


@pytest.mark.parametrize("drive", DRIVES)
async def test_merge_rides_the_live_tiling_after_split(drive):
    """The split lands first, then merges run on the post-split tiling;
    coverage holds at every step and every key stays readable."""
    async with kv_cluster(regions=_two_region_template(), drive=drive) as c:
        l1 = await c.wait_region_leader(1)
        for i in range(32):
            assert await l1.raft_store.put(b"k%02d" % i, b"v%d" % i)
        st = await l1.store_engine.apply_split(1, 3)
        assert st.is_ok(), str(st)
        await c.wait_region_on_all(3)
        l3 = await c.wait_region_leader(3)
        l2 = await c.wait_region_leader(2)
        store = next(iter(c.stores.values()))
        regs = [store.get_region_engine(i).region for i in (1, 2, 3)]
        assert coverage_errors(regs) == []
        st = await l3.store_engine.apply_merge(3, 2, str(l2.node.server_id))
        assert st.is_ok(), str(st)
        await _wait(lambda: all(s.get_region_engine(3) is None
                                for s in c.stores.values()),
                    what="child retirement")
        l1 = await c.wait_region_leader(1)
        l2 = await c.wait_region_leader(2)
        st = await l1.store_engine.apply_merge(1, 2, str(l2.node.server_id))
        assert st.is_ok(), str(st)
        await _wait(lambda: all(s.get_region_engine(1) is None
                                for s in c.stores.values()),
                    what="parent retirement")
        await _absorbed_everywhere(c, 2, drive)
        for s in c.stores.values():
            r2 = s.get_region_engine(2).region
            assert coverage_errors([r2]) == []
        l2 = await c.wait_region_leader(2)
        for i in range(32):
            assert await l2.raft_store.get(b"k%02d" % i) == b"v%d" % i


EP4 = [f"127.0.0.1:{6000 + i}" for i in range(4)]


@pytest.mark.parametrize("drive", DRIVES)
async def test_move_replica_to_fresh_store(drive):
    async with kv_cluster(4, regions=[Region(id=1, peers=EP4[:3])],
                          drive=drive) as c:
        joint = JointTicks(c)
        leader = await c.wait_region_leader(1)
        assert await leader.raft_store.put(b"k", b"v")
        src = next(p for p in leader.region.peers
                   if p != str(leader.node.server_id))
        st = await leader.store_engine.apply_move(1, EP4[3], src)
        assert st.is_ok(), str(st)
        ce = leader.node.conf_entry
        peers = {str(p) for p in ce.conf.peers}
        assert EP4[3] in peers and src not in peers
        assert ce.is_stable()
        assert leader.store_engine.moves_applied == 1
        st = await leader.store_engine.apply_move(1, EP4[3], src)
        assert st.is_ok(), str(st)
        assert await leader.raft_store.get(b"k") == b"v"
        if drive == "engine":
            # the joint promote+remove ran through the engine's tick:
            # some tick saw the group's old voter row, and once the
            # change is stable no row is left joint
            assert joint.n > 0
            eng = leader.store_engine.multi_raft_engine
            assert not eng.old_voter_mask.any()


@pytest.mark.parametrize("drive", DRIVES)
async def test_move_self_leader_source_hands_off_first(drive):
    async with kv_cluster(4, regions=[Region(id=1, peers=EP4[:3])],
                          drive=drive) as c:
        leader = await c.wait_region_leader(1)
        me = str(leader.node.server_id)
        st = await leader.store_engine.apply_move(1, EP4[3], me)
        assert st.code == RaftError.EBUSY, str(st)

        async def _moved():
            nl = await c.wait_region_leader(1)
            return str(nl.node.server_id) != me

        deadline = time.monotonic() + 8.0
        while not await _moved():
            assert time.monotonic() < deadline, \
                "leadership never left the move source"
            await asyncio.sleep(0.05)


@pytest.mark.parametrize("drive", DRIVES)
async def test_move_races_leader_kill(drive):
    """The engine drive ticks with the engine's numpy tick, the tick the
    JAX package's engine runs on a CPU host: with the torch tick's plain
    version (0.7-1.4 ms a tick on the CPU against 0.11-0.23 ms) the move
    takes 35-87 ms instead of 10-20, the kill at 50 ms lands inside it,
    and 4 of 135 runs under six-way load stalled on the source-leader
    hand-off that the reference's ``apply_move`` aims at the killed
    store (ROADMAP queue C)."""
    async with kv_cluster(4, regions=[Region(id=1, peers=EP4[:3])],
                          tmp_path=None, drive=drive,
                          backend="numpy") as c:
        leader = await c.wait_region_leader(1)
        leader_ep = leader.node.server_id.endpoint
        src = next(p for p in leader.region.peers
                   if p != str(leader.node.server_id))
        move = asyncio.ensure_future(
            leader.store_engine.apply_move(1, EP4[3], src))
        await asyncio.sleep(0.05)   # land mid-catchup / mid-joint
        await c.stop_store(leader_ep)
        with contextlib.suppress(Exception):
            await move
        new_leader = await c.wait_region_leader(1, timeout_s=10.0)
        deadline = time.monotonic() + 10.0
        while True:
            st = await new_leader.store_engine.apply_move(1, EP4[3], src)
            ce = new_leader.node.conf_entry
            peers = {str(p) for p in ce.conf.peers}
            if st.is_ok() and EP4[3] in peers and src not in peers \
                    and ce.is_stable():
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"move did not converge: {st} peers={peers}")
            await asyncio.sleep(0.2)
            new_leader = await c.wait_region_leader(1, timeout_s=10.0)
        assert await new_leader.raft_store.put(b"post", b"kill")


@pytest.mark.parametrize("drive", DRIVES)
async def test_pd_lifecycle_merges_cold_regions_end_to_end(drive):
    """A lifecycle PD merges an all-cold 4-region fleet down to the
    floor, and the client re-resolves routes out of the merged-away
    regions."""
    template = [
        Region(id=1, start_key=b"", end_key=b"g"),
        Region(id=2, start_key=b"g", end_key=b"n"),
        Region(id=3, start_key=b"n", end_key=b"t"),
        Region(id=4, start_key=b"t", end_key=b""),
    ]
    c = PDTestCluster(
        n_stores=3, n_pd=1, regions=template,
        heartbeat_interval_ms=100,
        pd_opts={
            "lifecycle": True,
            "lifecycle_min_regions": 2,
            "lifecycle_merge_cooldown_s": 0.5,
            "lifecycle_move_cooldown_s": 0.5,
            "lifecycle_max_inflight_merges": 1,
            # suppress moves: this test isolates the merge actuator
            "lifecycle_move_imbalance": 99,
        }, **engine_kw(drive))
    await c.start_all()
    try:
        pd = await c.wait_pd_leader()
        kv = RheaKVStore(c.pd_client(), c.client_transport(),
                         timeout_ms=3000, max_retries=16)
        await kv.start()
        for k in (b"a", b"h", b"p", b"x"):
            assert await kv.put(k, b"v-" + k)
        await _wait(lambda: len(pd.fsm.regions) <= 2
                    and not pd.fsm.pending_merges,
                    timeout_s=30.0, what="cold merges down to the floor")
        assert pd.merges_completed >= 2
        assert coverage_errors(pd.fsm.regions.values()) == []
        # pin the boot view back: all four regions, so each key of a
        # merged-away region routes through it and bounces.  A snapshot of
        # the client's own table is no pre-merge view: the PD can finish
        # both merges during the puts above, and a client that learned the
        # new layout from epoch bounces alone then holds no retired route
        # (merged_evictions stayed 0, in either package's copy of this test)
        kv.route_table.reset([r.copy() for r in c.region_template])
        for k in (b"a", b"h", b"p", b"x"):
            assert await kv.get(k) == b"v-" + k
        assert await kv.put(b"hh", b"post-merge")
        assert await kv.get(b"hh") == b"post-merge"
        assert kv.merged_evictions >= 1
        view = await kv.pd.cluster_describe()
        assert view and view.get("lifecycle"), view
        assert view["lifecycle"]["merges_completed"] >= 2
        await kv.shutdown()
    finally:
        await c.stop_all()


def test_replayed_split_report_cannot_resurrect_merged_region():
    """A mint-era split report replayed after the child has merged away
    must not resurrect it in the PD metadata (the tombstone wins)."""
    from tpuraft_torch.rheakv.pd_server import (
        _CMD_MERGE, _CMD_REGION_UPSERT, _CMD_SPLIT, PDMetadataFSM, _cmd)

    fsm = PDMetadataFSM()

    def upsert(region, leader=EP[0]):
        lb = leader.encode()
        fsm._dispatch(_cmd(
            _CMD_REGION_UPSERT,
            struct.pack("<H", len(lb)) + lb + region.encode()))

    upsert(_r(1, b"", b"m"))
    upsert(_r(2, b"m", b""))
    parent = _r(1, b"", b"g")
    parent.epoch.version = 2
    child = _r(1024, b"g", b"m")
    child.epoch.version = 2
    pb = parent.encode()
    split_report = _cmd(
        _CMD_SPLIT, struct.pack("<I", len(pb)) + pb + child.encode())
    assert fsm._dispatch(split_report) is True
    assert coverage_errors(fsm.regions.values()) == []
    assert fsm._dispatch(
        _cmd(_CMD_MERGE, struct.pack("<qq", 1024, 2))) is True
    assert 1024 not in fsm.regions
    assert fsm.retired_regions[1024] == 2
    assert fsm.regions[2].start_key == b"g"
    assert fsm._dispatch(split_report) is True
    assert 1024 not in fsm.regions, "merged-away child resurrected"
    assert fsm.regions[2].start_key == b"g"
    assert fsm.regions[2].end_key == b""
    assert coverage_errors(fsm.regions.values()) == []
    assert fsm._dispatch(
        _cmd(_CMD_MERGE, struct.pack("<qq", 1024, 2))) is False


async def test_target_coverage_alone_never_finalizes_pending_merge(tmp_path):
    """The target's extended range proves the absorb committed, not that
    the source's MERGE_COMMIT is durable: the pending pair survives the
    coverage report, keeps re-issuing, and finalizes only on an explicit
    pd_report_merge from the source group."""
    from tpuraft_torch.rheakv.pd_messages import (
        Instruction, ReportMergeRequest, StoreHeartbeatBatchRequest,
        encode_region_delta)
    from tpuraft_torch.rheakv.pd_server import _CMD_MERGE_ISSUED, _cmd

    c = PDTestCluster(
        n_stores=0, n_pd=1, tmp_path=tmp_path,
        pd_opts={"lifecycle": True,
                 "lifecycle_min_regions": 99,
                 "lifecycle_merge_cooldown_s": 0.01})
    for ep in c.pd_endpoints:
        await c.start_pd(ep)
    try:
        pd = await c.wait_pd_leader()
        pd_client = c.pd_client()
        store_ep = "127.0.0.1:9001"

        def hb(regions):
            return pd_client._call(
                "pd_store_heartbeat_batch",
                StoreHeartbeatBatchRequest(
                    store_id=1, endpoint=store_ep,
                    deltas=[encode_region_delta(r.encode(), store_ep, 5)
                            for r in regions],
                    full=True))

        src = Region(id=1, start_key=b"", end_key=b"m", peers=[store_ep])
        tgt = Region(id=2, start_key=b"m", end_key=b"", peers=[store_ep])
        resp = await hb([src, tgt])
        assert resp.success
        assert await pd._apply(
            _cmd(_CMD_MERGE_ISSUED, struct.pack("<qq", 1, 2))) == 2
        grown = Region(id=2, start_key=b"", end_key=b"",
                       peers=[store_ep])
        grown.epoch.version = 2
        await asyncio.sleep(0.05)   # clear the merge_reissue pacing
        resp = await hb([src, grown])
        assert resp.success
        assert pd.fsm.pending_merges == {1: 2}
        assert 1 in pd.fsm.regions
        assert 1 not in pd.fsm.retired_regions
        assert pd.merges_completed == 0
        ins = [Instruction.decode(b) for b in resp.instructions]
        merges = [i for i in ins if i.kind == Instruction.KIND_MERGE]
        assert merges, "pending merge stopped re-issuing"
        assert merges[0].region_id == 1
        assert merges[0].new_region_id == 2
        await pd_client._call("pd_report_merge", ReportMergeRequest(
            source_region_id=1, target_region_id=2))
        assert pd.fsm.pending_merges == {}
        assert 1 not in pd.fsm.regions
        assert pd.fsm.retired_regions[1] == 2
        assert pd.merges_completed == 1
        assert coverage_errors(pd.fsm.regions.values()) == []
    finally:
        await c.stop_all()


def test_duplicate_absorb_does_not_roll_back_target_writes():
    """A re-issued MERGE_ABSORB carrying the sealed source's original
    blob is a no-op once the first absorb landed: no data load, no epoch
    bump, no lost update."""
    from tpuraft_torch.rheakv.kv_operation import KVOperation
    from tpuraft_torch.rheakv.raw_store import MemoryRawKVStore
    from tpuraft_torch.rheakv.state_machine import KVStoreStateMachine

    src_store = MemoryRawKVStore()
    src_store.put(b"a", b"stale")
    blob = src_store.serialize_range(b"", b"m")
    tgt_store = MemoryRawKVStore()
    region = Region(id=2, start_key=b"m", end_key=b"")
    fsm = KVStoreStateMachine(region, tgt_store)
    absorb = KVOperation.merge_absorb(1, b"", b"m", blob)
    assert fsm._dispatch(absorb) is True
    assert (region.start_key, region.end_key) == (b"", b"")
    assert tgt_store.get(b"a") == b"stale"
    ver = region.epoch.version
    tgt_store.put(b"a", b"fresh")
    assert fsm._dispatch(absorb) is True
    assert tgt_store.get(b"a") == b"fresh"
    assert region.epoch.version == ver


def test_pd_merge_finalize_non_adjacent_degrades_gracefully():
    """A non-adjacent merge pair degrades to a logged violation inside
    the replicated PD FSM apply, never an exception out of on_apply."""
    from tpuraft_torch.rheakv.pd_server import (
        _CMD_MERGE, _CMD_REGION_UPSERT, PDMetadataFSM, _cmd)

    fsm = PDMetadataFSM()
    lb = EP[0].encode()
    for region in (_r(1, b"", b"g"), _r(2, b"t", b"")):
        fsm._dispatch(_cmd(
            _CMD_REGION_UPSERT,
            struct.pack("<H", len(lb)) + lb + region.encode()))
    assert fsm._dispatch(
        _cmd(_CMD_MERGE, struct.pack("<qq", 1, 2))) is True
    assert fsm.retired_regions[1] == 2
    assert fsm.regions[2].start_key == b"t"
    assert fsm.regions[2].end_key == b""


@pytest.mark.parametrize("drive", DRIVES)
async def test_failed_seal_propose_clears_leader_local_sealing(drive):
    """If the seal never applies, the leader-local sealing flag clears,
    the region keeps serving writes and a retried merge completes."""
    async with kv_cluster(regions=_two_region_template(), drive=drive) as c:
        l1 = await c.wait_region_leader(1)
        l2 = await c.wait_region_leader(2)
        tp = str(l2.node.server_id)

        async def boom(_target_id):
            raise RuntimeError("propose lost with leadership")

        l1.raft_store.merge_seal = boom
        st = await l1.store_engine.apply_merge(1, 2, tp)
        assert st.code == RaftError.EINTERNAL, str(st)
        assert getattr(l1.fsm, "sealed_into", -1) == -1
        assert l1.sealing is False, \
            "leader-local seal flag leaked after a failed attempt"
        assert await l1.raft_store.put(b"pre", b"merge")
        del l1.raft_store.merge_seal    # restore the real propose path
        st = await l1.store_engine.apply_merge(1, 2, tp)
        assert st.is_ok(), str(st)
        await _wait(lambda: all(s.get_region_engine(1) is None
                                for s in c.stores.values()),
                    what="retried merge completion")
        for s in c.stores.values():
            assert s._retired_into.get(1) == 2
        l2 = await c.wait_region_leader(2)
        assert await l2.raft_store.get(b"pre") == b"merge"
