"""The port's shared multi-group log engine (tpuraft_torch/native/
multilog.cc + tpuraft_torch.storage.multilog) on the CPU: one engine
instance per process and directory, group-keyed records in shared
journals, ONE fsync per flush round across all groups.

Port copies of the JAX package's tests/test_multilog.py, and
differentials against the JAX package, each held exactly: a seeded
script of appends, truncations and resets over many groups through both
packages' engines (every op's first and last index, every entry, again
after a reopen), and a journal written by each package opened by the
other.
"""

import asyncio
import os
import signal
import struct
import subprocess
import sys
import time

import pytest

from tests.test_torch_storage_native import _BaseLogStorageSuite, mk_entries
from tpuraft_torch.entity import LogId


@pytest.fixture(scope="module", autouse=True)
def _built():
    """Both packages' engines built (each from its own sources); a
    failed build fails the tests."""
    from tpuraft.storage.multilog import ensure_built as jbuild
    from tpuraft_torch.storage.multilog import ensure_built

    ensure_built()
    jbuild()


def mk_storage(tmp_path, group="g1", seg_max=0):
    from tpuraft_torch.storage.multilog import MultiLogStorage

    s = MultiLogStorage(str(tmp_path / "mlog"), group)
    if seg_max:
        # engine seg_max is fixed at first open per process+dir
        from tpuraft_torch.storage import multilog

        key = os.path.realpath(str(tmp_path / "mlog"))
        if key not in multilog._engines:
            multilog._engines[key] = multilog.MultiLogEngine(
                str(tmp_path / "mlog"), seg_max)
    return s


class TestMultiLogStorage(_BaseLogStorageSuite):
    """The generic LogStorage battery over one group of the shared
    engine (same contract as file/native single-group engines)."""

    def mk(self, tmp_path):
        return mk_storage(tmp_path)


def test_groups_are_independent(tmp_path):
    a = mk_storage(tmp_path, "ga")
    b = mk_storage(tmp_path, "gb")
    a.init()
    b.init()
    try:
        # interleaved appends share journals but not index spaces
        a.append_entries(mk_entries(1, 5, term=1))
        b.append_entries(mk_entries(1, 3, term=7))
        a.append_entries(mk_entries(6, 5, term=2))
        assert a.last_log_index() == 10
        assert b.last_log_index() == 3
        assert a.get_term(7) == 2 and b.get_term(2) == 7
        # truncation in one group leaves the other intact
        a.truncate_suffix(4)
        b.truncate_prefix(2)
        assert a.last_log_index() == 4
        assert b.first_log_index() == 2 and b.last_log_index() == 3
        assert a.engine is b.engine  # ONE engine instance
    finally:
        a.shutdown()
        b.shutdown()


def test_multi_group_restart_recovery(tmp_path):
    groups = [f"g{i}" for i in range(16)]
    stores = [mk_storage(tmp_path, g) for g in groups]
    for i, s in enumerate(stores):
        s.init()
        s.append_entries(mk_entries(1, 4 + i, term=i + 1))
    stores[3].truncate_suffix(2)
    stores[5].truncate_prefix(3)
    stores[7].reset(50)
    stores[7].append_entries(mk_entries(50, 2, term=9))
    for s in stores:
        s.shutdown()

    stores = [mk_storage(tmp_path, g) for g in groups]
    for s in stores:
        s.init()
    try:
        for i, s in enumerate(stores):
            if i == 3:
                assert s.last_log_index() == 2
            elif i == 5:
                assert (s.first_log_index(), s.last_log_index()) == (3, 9)
            elif i == 7:
                assert (s.first_log_index(), s.last_log_index()) == (50, 51)
                assert s.get_term(51) == 9
            else:
                assert s.last_log_index() == 4 + i, groups[i]
                assert s.get_entry(2).id == LogId(2, i + 1)
    finally:
        for s in stores:
            s.shutdown()


def test_thousand_groups_one_engine(tmp_path):
    """1K groups on ONE engine instance: fd count stays O(journal
    files), not O(groups) (round 1: thousands of open segment files)."""
    G = 1000
    stores = [mk_storage(tmp_path, f"r{k}") for k in range(G)]
    for s in stores:
        s.init()
    try:
        for k, s in enumerate(stores):
            s.append_entries(mk_entries(1, 2, term=k % 7 + 1), sync=False)
        eng = stores[0].engine
        eng.sync()
        assert eng.file_count <= 4, "journal files should be shared"
        # spot-check reads across the space
        for k in (0, 1, 499, 998, 999):
            assert stores[k].last_log_index() == 2
            assert stores[k].get_term(2) == k % 7 + 1
    finally:
        for s in stores:
            s.shutdown()
    # reopen: all 1000 groups recover
    stores = [mk_storage(tmp_path, f"r{k}") for k in range(G)]
    for s in stores:
        s.init()
    try:
        assert all(s.last_log_index() == 2 for s in stores)
    finally:
        for s in stores:
            s.shutdown()


async def test_group_fsync_coalescing(tmp_path):
    """The headline property: N groups flushing concurrently cost ~1
    fsync round, not N (RocksDB group commit)."""
    G = 64
    stores = [mk_storage(tmp_path, f"c{k}") for k in range(G)]
    for s in stores:
        s.init()
    try:
        eng = stores[0].engine
        sync0 = eng.sync_count

        async def flush_one(k):
            await stores[k].append_entries_async(
                mk_entries(1, 3, term=1), sync=True)

        await asyncio.gather(*(flush_one(k) for k in range(G)))
        rounds = eng.sync_count - sync0
        # every group's flush is durable, but the 64 concurrent flushes
        # coalesced into a handful of fsync rounds
        assert rounds <= G // 4, f"{rounds} fsync rounds for {G} groups"
        assert all(s.last_log_index() == 3 for s in stores)
        print(f"{G} group flushes -> {rounds} fsync rounds")
    finally:
        for s in stores:
            s.shutdown()


def test_group_commit_across_event_loops(tmp_path):
    """The engine is shared process-wide by directory, so stores on
    DIFFERENT event loops (threads) may join the same group-commit; each
    waiter must resolve on its own loop (ADVICE r2: futures were set
    from whichever loop ran the round — not thread-safe)."""
    import threading

    from tests.test_torch_storage_native import mk_entries

    T, ROUNDS = 4, 25
    errors: list[BaseException] = []
    barrier = threading.Barrier(T)

    def worker(k: int) -> None:
        async def run():
            s = mk_storage(tmp_path, f"loop{k}")
            s.init()
            try:
                for i in range(ROUNDS):
                    await s.append_entries_async(
                        mk_entries(3 * i + 1, 3, term=1), sync=True)
                    # stagger so rounds interleave across loops
                    await asyncio.sleep(0.001 * (k % 3))
                assert s.last_log_index() == 3 * ROUNDS
            finally:
                s.shutdown()

        barrier.wait(timeout=30)
        try:
            asyncio.run(run())
        except BaseException as e:  # noqa: BLE001 — surfaced to the test
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    # a stranded waiter hangs its worker inside asyncio.run — join()
    # returning on timeout must fail the test, not pass it silently
    assert not any(t.is_alive() for t in threads), "worker deadlocked"
    assert not errors, errors


def test_journal_gc_after_prefix_truncation(tmp_path):
    s = mk_storage(tmp_path, "g1", seg_max=4096)
    s.init()
    try:
        s.append_entries(mk_entries(1, 200, term=1, size=64))
        eng = s.engine
        files_before = eng.file_count
        assert files_before > 2  # rotated
        s.truncate_prefix(190)  # storage gc()s opportunistically
        assert eng.file_count < files_before
        # data still intact post-GC
        assert s.first_log_index() == 190
        assert s.last_log_index() == 200
        assert s.get_entry(195) is not None
    finally:
        s.shutdown()
    # and recovery after GC (markers re-asserted state)
    s = mk_storage(tmp_path, "g1")
    s.init()
    try:
        assert (s.first_log_index(), s.last_log_index()) == (190, 200)
    finally:
        s.shutdown()


def test_torn_tail_recovery(tmp_path):
    s = mk_storage(tmp_path, "g1")
    s.init()
    s.append_entries(mk_entries(1, 3, size=40))
    s.shutdown()
    j = sorted((tmp_path / "mlog").glob("journal_*.log"))[0]
    j.write_bytes(j.read_bytes()[:-10])
    s = mk_storage(tmp_path, "g1")
    s.init()
    try:
        assert s.last_log_index() == 2
        assert s.get_entry(2) is not None
    finally:
        s.shutdown()


def test_torn_registry_tail_recovery(tmp_path):
    """The group registry is append-only (r5: per-registration rewrites
    made 16K boot O(G^2)); a torn registration append must be dropped
    at reopen while every completed registration survives, and new
    registrations must extend the cleaned stream."""
    stores = [mk_storage(tmp_path, f"g{i}") for i in range(8)]
    for s in stores:
        s.init()
        s.append_entries(mk_entries(1, 2, size=40))
    for s in stores:
        s.shutdown()
    reg = tmp_path / "mlog" / "groups"
    reg.write_bytes(reg.read_bytes() + b"\x05\x00\x00\x00")  # torn append
    back = [mk_storage(tmp_path, f"g{i}") for i in range(8)]
    for s in back:
        s.init()
    try:
        for s in back:
            assert s.last_log_index() == 2
            assert s.get_entry(1) is not None
        extra = mk_storage(tmp_path, "g-new")
        extra.init()
        extra.append_entries(mk_entries(1, 1, size=40))
        assert extra.last_log_index() == 1
        extra.shutdown()
    finally:
        for s in back:
            s.shutdown()
    # and the new registration is durable across another reopen
    again = mk_storage(tmp_path, "g-new")
    again.init()
    assert again.last_log_index() == 1
    again.shutdown()


def test_corrupt_record_drops_tail(tmp_path):
    """A flipped byte mid-journal: recovery keeps the clean prefix, the
    engine reopens (no exception, no half-read groups)."""
    s = mk_storage(tmp_path, "g1")
    s.init()
    s.append_entries(mk_entries(1, 10, size=40))
    s.shutdown()
    j = sorted((tmp_path / "mlog").glob("journal_*.log"))[0]
    data = bytearray(j.read_bytes())
    data[len(data) // 2] ^= 0xFF
    j.write_bytes(bytes(data))
    s = mk_storage(tmp_path, "g1")
    s.init()
    try:
        last = s.last_log_index()
        assert 0 < last < 10
        for i in range(s.first_log_index(), last + 1):
            assert s.get_entry(i) is not None
    finally:
        s.shutdown()


_KILL_WRITER = r"""
import sys, time
sys.path.insert(0, {repo!r})
from tpuraft_torch.entity import EntryType, LogEntry, LogId
from tpuraft_torch.storage.multilog import MultiLogStorage

def mk_entries(first, count, term=1, size=16):
    return [LogEntry(type=EntryType.DATA, id=LogId(first + i, term),
                     data=bytes(size)) for i in range(count)]

d = {dir!r}
stores = [MultiLogStorage(d, "k%d" % k) for k in range(8)]
for s in stores:
    s.init()
print("READY", flush=True)
i = 1
while True:
    for k, s in enumerate(stores):
        s.append_entries(mk_entries(i, 1, term=1, size=32), sync=(k == 7))
    i += 1
"""


def test_kill9_recovery_per_group(tmp_path):
    """kill -9 a process writing 8 groups through one engine; reopen:
    every group's log is contiguous with no exception."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = _KILL_WRITER.format(repo=repo, dir=str(tmp_path / "mlog"))
    env = dict(os.environ, PYTHONPATH=repo)
    p = subprocess.Popen([sys.executable, "-c", script],
                         stdout=subprocess.PIPE, env=env)
    try:
        assert p.stdout.readline().strip() == b"READY"
        time.sleep(1.0)  # let it write under fire
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait()

    stores = [mk_storage(tmp_path, f"k{k}") for k in range(8)]
    for s in stores:
        s.init()
    try:
        lasts = [s.last_log_index() for s in stores]
        assert min(lasts) > 5, lasts  # it was really writing
        for s, last in zip(stores, lasts):
            # contiguity: every index up to last reads back
            for i in range(1, last + 1):
                e = s.get_entry(i)
                assert e is not None and e.id.index == i
        # all groups within one sync round of each other
        assert max(lasts) - min(lasts) <= 2, lasts
    finally:
        for s in stores:
            s.shutdown()


async def test_kv_store_regions_share_one_log_engine(tmp_path):
    """RheaKV production integration: StoreEngineOptions(log_scheme=
    "multilog") puts every region of a store on ONE shared journal
    engine — writes across regions coalesce into shared fsync rounds
    and survive a store restart."""
    from tests.test_torch_kv import DISK_BUDGET, KVTestCluster
    from tpuraft_torch.rheakv.metadata import Region
    from tpuraft_torch.storage import multilog

    regions = [Region(id=1, start_key=b"", end_key=b"m"),
               Region(id=2, start_key=b"m", end_key=b"")]
    c = KVTestCluster(3, tmp_path=tmp_path, regions=regions,
                      log_scheme="multilog",
                      store_opts={"disk_budget_bytes": DISK_BUDGET})
    await c.start_all()
    try:
        l1 = await c.wait_region_leader(1)
        l2 = await c.wait_region_leader(2)
        for i in range(10):
            assert await l1.raft_store.put(b"a%03d" % i, b"v%d" % i)
            assert await l2.raft_store.put(b"z%03d" % i, b"v%d" % i)
        # both regions' logs live in each store's ONE engine
        engines = list(multilog._engines.values())
        assert engines, "no shared engines registered"
        assert len(engines) == 3  # one per store, not one per region
        # restart a store: both its region logs recover from the engine
        victim = c.endpoints[0]
        await c.stop_store(victim)
        await c.start_store(victim)
        l1 = await c.wait_region_leader(1)
        assert await l1.raft_store.get(b"a005") == b"v5"
        l2 = await c.wait_region_leader(2)
        assert await l2.raft_store.get(b"z007") == b"v7"
    finally:
        await c.stop_all()


async def test_cluster_on_shared_log_engine(tmp_path):
    """End-to-end: 3 endpoints x 8 groups, every endpoint's groups on
    ONE shared log engine, electing and committing through the port's
    engine plane (ticking on the CPU) with group-commit fsync."""
    from tpuraft_torch.conf import Configuration
    from tpuraft_torch.core.engine import MultiRaftEngine
    from tpuraft_torch.core.node import Node, State
    from tpuraft_torch.core.node_manager import NodeManager
    from tpuraft_torch.core.state_machine import StateMachine
    from tpuraft_torch.entity import PeerId, Task
    from tpuraft_torch.options import NodeOptions, TickOptions
    from tpuraft_torch.rpc.transport import (InProcNetwork, InProcTransport,
                                             RpcServer)

    class MockStateMachine(StateMachine):
        def __init__(self):
            self.logs: list[bytes] = []

        async def on_apply(self, it) -> None:
            while it.valid():
                self.logs.append(it.data())
                it.next()

    net = InProcNetwork()
    endpoints = [PeerId.parse(f"127.0.0.1:{6000 + i}") for i in range(3)]
    conf = Configuration(list(endpoints))
    groups = [f"g{k}" for k in range(8)]
    engines, nodes = {}, {}
    # one shared log dir per endpoint
    for ep in endpoints:
        server = RpcServer(ep.endpoint)
        manager = NodeManager(server)
        net.bind(server)
        transport = InProcTransport(net, ep.endpoint)
        engine = MultiRaftEngine(TickOptions(
            max_groups=len(groups) + 4, max_peers=8, tick_interval_ms=5,
            device="cpu"))
        await engine.start()
        engines[ep.endpoint] = engine
        factory = engine.ballot_box_factory()
        mdir = f"{tmp_path}/{ep.port}/mlog"
        for gid in groups:
            opts = NodeOptions(
                election_timeout_ms=500, initial_conf=conf.copy(),
                fsm=MockStateMachine(),
                log_uri=f"multilog://{mdir}#{gid}",
                raft_meta_uri=f"file://{tmp_path}/{ep.port}/meta_{gid}")
            node = Node(gid, ep, opts, transport, ballot_box_factory=factory)
            node.node_manager = manager
            manager.add(node)
            assert await node.init()
            nodes[(gid, ep)] = node

    async def wait_leader(gid, timeout_s=10.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ls = [n for (g, _), n in nodes.items()
                  if g == gid and n.state == State.LEADER]
            if len(ls) == 1:
                return ls[0]
            await asyncio.sleep(0.02)
        raise TimeoutError(gid)

    try:
        async def put(gid, i):
            leader = await wait_leader(gid)
            fut = asyncio.get_running_loop().create_future()
            await leader.apply(Task(data=b"%s-%d" % (gid.encode(), i),
                                    done=fut.set_result))
            st = await asyncio.wait_for(fut, 15)
            assert st.is_ok(), f"{gid}: {st}"

        await asyncio.gather(*(put(g, i) for g in groups for i in range(3)))
        # one engine dir per endpoint; fsyncs coalesced across groups
        from tpuraft_torch.storage import multilog

        engines_ml = [e for e in multilog._engines.values()]
        assert engines_ml, "shared engines should be registered"
        for eng in engines_ml:
            assert eng.sync_count <= eng.append_count
    finally:
        for node in nodes.values():
            await node.shutdown()
        for engine in engines.values():
            await engine.shutdown()


# -- differentials against the JAX package ----------------------------------------

def _open_groups(mod, root, n_groups):
    ss = [mod.MultiLogStorage(str(root), f"r{g}") for g in range(n_groups)]
    for s in ss:
        s.init()
    return ss


def test_multilog_script_matches_jax(tmp_path):
    """One seeded script of appends, truncations and resets over 48
    groups through both packages' shared journals: every op's (first,
    last), then every group's entries and configuration indexes, the
    same; again after both engines close and reopen."""
    import tpuraft.entity as jentity
    import tpuraft.storage.multilog as jml
    import tpuraft_torch.entity as tentity
    from tests.test_torch_storage_native import (apply_log_op, log_image,
                                                 log_script)
    from tpuraft_torch.storage import multilog as tml

    n_groups = 48
    ops = log_script(21, n_groups, 700)
    assert {op[0] for op in ops} == {"append", "truncate_suffix",
                                     "truncate_prefix", "reset"}
    js = _open_groups(jml, tmp_path / "jax", n_groups)
    ts = _open_groups(tml, tmp_path / "torch", n_groups)
    assert js[0].engine is js[-1].engine and ts[0].engine is ts[-1].engine
    assert [apply_log_op(jentity, js, op) for op in ops] == \
        [apply_log_op(tentity, ts, op) for op in ops]
    image = log_image(js)
    assert log_image(ts) == image
    for s in js + ts:
        s.shutdown()
    assert not jml._engines and not tml._engines  # both engines closed
    js = _open_groups(jml, tmp_path / "jax", n_groups)
    ts = _open_groups(tml, tmp_path / "torch", n_groups)
    try:
        assert log_image(js) == log_image(ts) == image
    finally:
        for s in js + ts:
            s.shutdown()


def test_multilog_journals_open_across_packages(tmp_path):
    """A shared journal written by each package opens in the other with
    every group's entries equal; the reader extends one group and the
    writer reads that entry back."""
    import tpuraft.entity as jentity
    import tpuraft.storage.multilog as jml
    import tpuraft_torch.entity as tentity
    from tests.test_torch_storage_native import (apply_log_op, log_image,
                                                 log_script, to_entries)
    from tpuraft_torch.storage import multilog as tml

    n_groups = 12
    ops = log_script(4, n_groups, 200)
    images = {}
    for mod, pkg in ((jml, jentity), (tml, tentity)):
        ss = _open_groups(mod, tmp_path / mod.__name__, n_groups)
        for op in ops:
            apply_log_op(pkg, ss, op)
        images[mod.__name__] = log_image(ss)
        for s in ss:
            s.shutdown()
    assert images[jml.__name__] == images[tml.__name__]
    for reader, pkg, writer in ((tml, tentity, jml), (jml, jentity, tml)):
        root = tmp_path / writer.__name__
        ss = _open_groups(reader, root, n_groups)
        try:
            assert log_image(ss) == images[writer.__name__]
            last = ss[0].last_log_index()
            ss[0].append_entries(
                to_entries(pkg, [(1, last + 1, 77, b"across", None)]))
        finally:
            for s in ss:
                s.shutdown()
        back = _open_groups(writer, root, 1)
        try:
            assert back[0].last_log_index() == last + 1
            assert back[0].get_entry(last + 1).data == b"across"
        finally:
            back[0].shutdown()
