"""The port's snapshot subsystem: ``storage/snapshot.py`` and
``core/snapshot_executor.py`` (port copies of the JAX package's
``tests/test_snapshot.py`` cases), with every node driven by a port
engine ticking on the CPU, so the periodic snapshot rides the tick's
``snap_due`` lane."""

from __future__ import annotations

import asyncio
import struct
import time

import pytest

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.cli_service import CliProcessors
from tpuraft_torch.core.engine import MultiRaftEngine
from tpuraft_torch.core.node import Node, State
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.core.state_machine import Iterator, StateMachine
from tpuraft_torch.entity import PeerId, Task
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.options import NodeOptions, TickOptions
from tpuraft_torch.rpc.messages import SnapshotMeta
from tpuraft_torch.rpc.transport import InProcNetwork, InProcTransport, RpcServer
from tpuraft_torch.storage.snapshot import LocalSnapshotStorage


class MockStateMachine(StateMachine):
    """Records applied entries; snapshots them as one length-prefixed
    blob (the JAX package's ``tests/cluster.py`` MockStateMachine)."""

    def __init__(self):
        self.logs: list[bytes] = []
        self.snapshots_saved = 0
        self.snapshots_loaded = 0

    async def on_apply(self, it: Iterator) -> None:
        while it.valid():
            self.logs.append(it.data())
            it.next()

    async def on_snapshot_save(self, writer, done) -> None:
        blob = struct.pack("<I", len(self.logs)) + b"".join(
            struct.pack("<I", len(x)) + x for x in self.logs)
        writer.write_file("data", blob)
        self.snapshots_saved += 1
        done(Status.OK())

    async def on_snapshot_load(self, reader) -> bool:
        blob = reader.read_file("data")
        if blob is None:
            return False
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        self.logs = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", blob, off)
            off += 4
            self.logs.append(bytes(blob[off:off + ln]))
            off += ln
        self.snapshots_loaded += 1
        return True


class EngineTestCluster:
    """N port Nodes of one group in one process over the loopback
    transport, each endpoint's node driven by its own port engine on the
    CPU (the JAX package's TestCluster with snapshots on, engine-backed)."""

    __test__ = False

    def __init__(self, n: int, tmp_path, election_timeout_ms: int = 300,
                 snapshot_interval_secs: int = 0):
        self.net = InProcNetwork()
        self.group_id = "test_group"
        self.peers = [PeerId.parse(f"127.0.0.1:{5000 + i}") for i in range(n)]
        self.conf = Configuration(list(self.peers))
        self.tmp_path = tmp_path
        self.election_timeout_ms = election_timeout_ms
        self.snapshot_interval_secs = snapshot_interval_secs
        self.nodes: dict[PeerId, Node] = {}
        self.fsms: dict[PeerId, MockStateMachine] = {}
        self.engines: dict[PeerId, MultiRaftEngine] = {}

    def _options(self, peer: PeerId) -> NodeOptions:
        base = f"{self.tmp_path}/{peer.ip}_{peer.port}"
        opts = NodeOptions(
            election_timeout_ms=self.election_timeout_ms,
            initial_conf=self.conf.copy(), fsm=self.fsms[peer],
            log_uri=f"file://{base}/log", raft_meta_uri=f"file://{base}/meta",
            snapshot_uri=f"file://{base}/snapshot")
        opts.snapshot.interval_secs = self.snapshot_interval_secs
        return opts

    async def start_all(self) -> None:
        for p in self.peers:
            await self.start(p)

    async def start(self, peer: PeerId) -> Node:
        self.fsms.setdefault(peer, MockStateMachine())
        server = RpcServer(peer.endpoint)
        manager = NodeManager(server)
        CliProcessors(manager)
        self.net.bind(server)
        self.net.start_endpoint(peer.endpoint)
        transport = InProcTransport(self.net, peer.endpoint)
        engine = MultiRaftEngine(TickOptions(
            max_groups=4, max_peers=4, tick_interval_ms=2, device="cpu"))
        await engine.start()
        self.engines[peer] = engine
        node = Node(self.group_id, peer, self._options(peer), transport,
                    ballot_box_factory=engine.ballot_box_factory())
        node.node_manager = manager
        manager.add(node)
        assert await node.init(), f"init failed for {peer}"
        self.nodes[peer] = node
        return node

    async def stop(self, peer: PeerId) -> None:
        self.net.stop_endpoint(peer.endpoint)
        node = self.nodes.pop(peer, None)
        if node:
            self.net.unbind(peer.endpoint)
            await node.shutdown()
        engine = self.engines.pop(peer, None)
        if engine:
            await engine.shutdown()

    async def stop_all(self) -> None:
        for p in list(self.nodes):
            await self.stop(p)

    async def wait_leader(self, timeout_s: float = 5.0) -> Node:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            leaders = [n for n in self.nodes.values()
                       if n.state == State.LEADER]
            if len(leaders) == 1:
                return leaders[0]
            await asyncio.sleep(0.02)
        raise TimeoutError(f"no leader in {timeout_s}s")

    async def apply_ok(self, node: Node, data: bytes,
                       timeout_s: float = 5.0) -> Status:
        """Apply and wait for the commit ack, retrying a propose-time
        EPERM through the current leader."""
        deadline = time.monotonic() + timeout_s
        while True:
            fut = asyncio.get_running_loop().create_future()
            await node.apply(Task(data=data,
                                  done=lambda st: fut.set_result(st)))
            st = await asyncio.wait_for(
                fut, max(0.1, deadline - time.monotonic()))
            if (st.is_ok() or st.raft_error != RaftError.EPERM
                    or time.monotonic() >= deadline):
                return st
            await asyncio.sleep(0.05)
            node = await self.wait_leader(
                max(0.1, deadline - time.monotonic()))

    @staticmethod
    async def drain_sends_to(leader, endpoint: str,
                             timeout_s: float = 5.0) -> None:
        """Wait until the leader's send plane holds nothing queued or in
        flight to ``endpoint`` (so a restarted follower catches up by
        InstallSnapshot, not by a pre-compaction frame still in flight)."""
        sender = leader.node_manager.send_plane.sender(endpoint)
        deadline = time.monotonic() + timeout_s
        while (sender.queued() or (sender._task is not None
                                   and not sender._task.done())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"send plane to {endpoint} never drained")
            await asyncio.sleep(0.02)

    async def wait_applied(self, count: int, timeout_s: float = 5.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(len(self.fsms[p].logs) >= count for p in self.nodes):
                return
            await asyncio.sleep(0.02)
        raise TimeoutError({str(p): len(self.fsms[p].logs)
                            for p in self.nodes})


# -- LocalSnapshotStorage --------------------------------------------------------

class TestLocalSnapshotStorage:
    def test_roundtrip(self, tmp_path):
        s = LocalSnapshotStorage(str(tmp_path))
        s.init()
        assert s.open() is None
        w = s.create()
        w.write_file("a", b"alpha")
        w.write_file("b", b"beta" * 100)
        s.commit(w, SnapshotMeta(last_included_index=7, last_included_term=2,
                                 peers=["1.1.1.1:1"]))
        r = s.open()
        assert r is not None
        assert r.load_meta().last_included_index == 7
        assert r.read_file("a") == b"alpha"
        assert r.read_file("b") == b"beta" * 100
        assert r.read_file("missing") is None

    def test_only_newest_kept(self, tmp_path):
        s = LocalSnapshotStorage(str(tmp_path))
        s.init()
        for idx in (5, 9):
            w = s.create()
            w.write_file("d", b"x%d" % idx)
            s.commit(w, SnapshotMeta(last_included_index=idx))
        assert len(s._snapshot_dirs()) == 1
        assert s.open().load_meta().last_included_index == 9

    def test_corrupt_file_detected(self, tmp_path):
        s = LocalSnapshotStorage(str(tmp_path))
        s.init()
        w = s.create()
        w.write_file("d", b"payload")
        s.commit(w, SnapshotMeta(last_included_index=3))
        (tmp_path / "snapshot_3" / "d").write_bytes(b"tampered")
        r = s.open()
        with pytest.raises(IOError):
            r.read_file("d")

    def test_chunked_read(self, tmp_path):
        s = LocalSnapshotStorage(str(tmp_path))
        s.init()
        w = s.create()
        w.write_file("big", bytes(range(256)) * 10)
        s.commit(w, SnapshotMeta(last_included_index=1))
        r = s.open()
        out = bytearray()
        off = 0
        while True:
            data, eof = r.read_chunk("big", off, 100)
            out += data
            off += len(data)
            if eof:
                break
        assert bytes(out) == bytes(range(256)) * 10


def test_storage_reads_a_jax_package_snapshot(tmp_path):
    """A snapshot the JAX package's storage committed opens in the port's
    byte for byte (the on-disk format is shared)."""
    from tpuraft.rpc.messages import SnapshotMeta as JMeta
    from tpuraft.storage.snapshot import LocalSnapshotStorage as JStorage

    js = JStorage(str(tmp_path))
    js.init()
    w = js.create()
    w.write_file("data", b"from-jax" * 50)
    js.commit(w, JMeta(last_included_index=11, last_included_term=3,
                       peers=["1.1.1.1:1", "2.2.2.2:2"]))
    r = LocalSnapshotStorage(str(tmp_path))
    r.init()
    reader = r.open()
    meta = reader.load_meta()
    assert (meta.last_included_index, meta.last_included_term,
            meta.peers) == (11, 3, ["1.1.1.1:1", "2.2.2.2:2"])
    assert reader.read_file("data") == b"from-jax" * 50


# -- the executor on engine-backed nodes -------------------------------------------

async def test_snapshot_save_and_restart_recovery(tmp_path):
    c = EngineTestCluster(3, tmp_path)
    await c.start_all()
    leader = await c.wait_leader()
    for i in range(20):
        await c.apply_ok(leader, b"e%d" % i)
    await c.wait_applied(20)
    st = await leader.snapshot()
    assert st.is_ok(), str(st)
    assert c.fsms[leader.server_id].snapshots_saved == 1
    # log compacted behind the snapshot
    assert leader.log_manager.first_log_index() > 1
    for i in range(20, 25):
        await c.apply_ok(leader, b"e%d" % i)
    await c.wait_applied(25)
    await c.stop_all()
    # restart: the leader-side node restores from snapshot + log tail
    c2 = EngineTestCluster(3, tmp_path)
    c2.net = c.net
    await c2.start_all()
    leader2 = await c2.wait_leader()
    await c2.apply_ok(leader2, b"e25")
    await c2.wait_applied(26)
    for p in c2.peers:
        assert c2.fsms[p].logs == [b"e%d" % i for i in range(26)], str(p)
    assert any(c2.fsms[p].snapshots_loaded > 0 for p in c2.peers)
    await c2.stop_all()


async def test_install_snapshot_to_lagging_follower(tmp_path):
    c = EngineTestCluster(3, tmp_path)
    await c.start_all()
    leader = await c.wait_leader()
    victim = next(p for p in c.peers if p != leader.server_id)
    await c.apply_ok(leader, b"s0")
    await c.wait_applied(1)
    # crash one follower, write + snapshot + compact so the log is gone
    await c.stop(victim)
    for i in range(1, 15):
        await c.apply_ok(leader, b"s%d" % i)
    st = await leader.snapshot()
    assert st.is_ok(), str(st)
    assert (leader.log_manager.first_log_index()
            == leader.fsm_caller.last_applied_index + 1)
    await c.drain_sends_to(leader, victim.endpoint)
    await c.start(victim)
    await c.wait_applied(15, timeout_s=10)
    assert c.fsms[victim].logs == [b"s%d" % i for i in range(15)]
    assert c.fsms[victim].snapshots_loaded >= 1
    await c.stop_all()


async def test_periodic_snapshot_timer_compacts(tmp_path):
    """The periodic snapshot fires on its own through the tick's snap_due
    lane (an engine-backed node has no snapshot timer), saves a
    snapshot, and compacts the log."""
    c = EngineTestCluster(3, tmp_path, snapshot_interval_secs=1)
    await c.start_all()
    leader = await c.wait_leader()
    assert leader._snapshot_timer is None
    for i in range(10):
        await c.apply_ok(leader, b"p%d" % i)
    await c.wait_applied(10)
    deadline = asyncio.get_running_loop().time() + 6
    while asyncio.get_running_loop().time() < deadline:
        if c.fsms[leader.server_id].snapshots_saved >= 1:
            break
        await asyncio.sleep(0.1)
    assert c.fsms[leader.server_id].snapshots_saved >= 1
    deadline = asyncio.get_running_loop().time() + 3
    while asyncio.get_running_loop().time() < deadline:
        if leader.log_manager.first_log_index() > 1:
            break
        await asyncio.sleep(0.1)
    assert leader.log_manager.first_log_index() > 1
    st = await c.apply_ok(leader, b"post-snap")
    assert st.is_ok()
    await c.stop_all()


async def test_snapshot_nothing_new_rejected(tmp_path):
    c = EngineTestCluster(1, tmp_path)
    await c.start_all()
    leader = await c.wait_leader()
    await c.apply_ok(leader, b"x")
    await c.wait_applied(1)
    st = await leader.snapshot()
    assert st.is_ok()
    st2 = await leader.snapshot()
    assert not st2.is_ok()  # nothing new
    await c.stop_all()
