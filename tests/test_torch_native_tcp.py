"""The port's native transport (tpuraft_torch/rpc/native_tcp.py over the
C++ epoll engine it builds from tpuraft_torch/native): the port copies of
the JAX package's ``tests/test_native_tcp.py`` (framing, pipelining,
reconnect, interop with the pure-Python TCP transport, a raft cluster,
snapshot install and injected faults over real sockets), and an interop
differential: the JAX package's native client against the port's native
server and the reverse, each decoding the same bytes the other sent.
"""

from __future__ import annotations

import asyncio
import os
import time
import types
from collections import Counter

import numpy as np
import pytest

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.cli_service import CliProcessors
from tpuraft_torch.core.node import Node, State
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.entity import PeerId, Task
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.options import NodeOptions
from tpuraft_torch.rpc import native_tcp
from tpuraft_torch.rpc.messages import GetFileResponse, ReadIndexResponse
from tpuraft_torch.rpc.native_tcp import (
    NativeTcpRpcServer,
    NativeTcpTransport,
    ensure_built,
)
from tpuraft_torch.rpc.tcp import TcpRpcServer, TcpTransport
from tpuraft_torch.rpc.transport import RpcError

from tests.test_torch_snapshot import MockStateMachine

PORT_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tpuraft_torch", "native")


@pytest.fixture(scope="module", autouse=True)
def built():
    ensure_built()


def _rir(i: int) -> ReadIndexResponse:
    return ReadIndexResponse(index=i, success=True)


async def _start_server(server_cls=TcpRpcServer):
    """Start an ephemeral-port server and pin its real endpoint."""
    srv = server_cls("127.0.0.1:0")
    await srv.start()
    srv.endpoint = f"127.0.0.1:{srv.bound_port}"
    return srv


class TcpCluster:
    """3 port raft nodes over real TCP sockets on ephemeral ports (the
    port copy of ``tests/test_tcp.py``'s TcpCluster)."""

    server_cls = TcpRpcServer
    transport_cls = TcpTransport

    def __init__(self, tmp_path=None, snapshot: bool = False):
        if snapshot and tmp_path is None:
            raise ValueError("snapshot=True needs a tmp_path")
        self.snapshot = snapshot
        self.nodes: dict[PeerId, Node] = {}
        self.fsms: dict[PeerId, MockStateMachine] = {}
        self.servers: dict = {}
        self.transports: dict = {}
        self.peers: list[PeerId] = []
        self.conf = Configuration()
        self.tmp_path = tmp_path

    async def start(self, n: int) -> None:
        servers = [await _start_server(self.server_cls) for _ in range(n)]
        self.peers = [PeerId.parse(s.endpoint) for s in servers]
        self.conf = Configuration(list(self.peers))
        for peer, srv in zip(self.peers, servers):
            await self._boot(peer, srv)

    async def _boot(self, peer: PeerId, srv) -> None:
        fsm = self.fsms.setdefault(peer, MockStateMachine())
        manager = NodeManager(srv)
        CliProcessors(manager)
        transport = self.transport_cls(endpoint=peer.endpoint)
        opts = NodeOptions(election_timeout_ms=300,
                           initial_conf=self.conf.copy(), fsm=fsm)
        if self.tmp_path is not None:
            base = f"{self.tmp_path}/{peer.ip}_{peer.port}"
            opts.log_uri = f"file://{base}/log"
            opts.raft_meta_uri = f"file://{base}/meta"
            if self.snapshot:
                opts.snapshot_uri = f"file://{base}/snapshot"
        else:
            opts.log_uri = "memory://"
            opts.raft_meta_uri = "memory://"
        opts.snapshot.interval_secs = 0
        node = Node("tcp_group", peer, opts, transport)
        node.node_manager = manager
        manager.add(node)
        assert await node.init()
        self.nodes[peer] = node
        self.servers[peer] = srv
        self.transports[peer] = transport

    async def crash(self, peer: PeerId) -> None:
        await self.servers[peer].stop()
        await self.transports[peer].close()
        node = self.nodes.pop(peer)
        await node.shutdown()

    async def restart(self, peer: PeerId) -> None:
        srv = self.server_cls(peer.endpoint)
        await srv.start()
        # a fresh FSM recorder: the node replays its durable log on init
        self.fsms.pop(peer, None)
        await self._boot(peer, srv)

    async def stop_all(self) -> None:
        for peer in list(self.nodes):
            await self.crash(peer)

    async def wait_leader(self, timeout_s: float = 8.0) -> Node:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            leaders = [x for x in self.nodes.values()
                       if x.state == State.LEADER]
            if len(leaders) == 1:
                return leaders[0]
            await asyncio.sleep(0.02)
        raise TimeoutError("no leader over tcp")

    async def apply_ok(self, node: Node, data: bytes) -> Status:
        fut = asyncio.get_running_loop().create_future()
        await node.apply(Task(data=data, done=lambda st: fut.set_result(st)))
        return await asyncio.wait_for(fut, 8.0)

    async def wait_applied(self, count: int, timeout_s: float = 8.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(len(self.fsms[p].logs) >= count for p in self.nodes):
                return
            await asyncio.sleep(0.02)
        raise TimeoutError(
            f"applied: { {str(p): len(self.fsms[p].logs) for p in self.nodes} }")


async def drain_sends_to(leader, endpoint: str, timeout_s: float = 5.0):
    """Wait until the leader's send plane has nothing queued or in flight
    to `endpoint` (``tests/cluster.py``'s TestCluster.drain_sends_to): a
    frame built from the not-yet-compacted log and delivered to the
    restarted follower would catch it up past the snapshot install."""
    sender = leader.node_manager.send_plane.sender(endpoint)
    deadline = time.monotonic() + timeout_s
    while (sender.queued() or (sender._task is not None
                               and not sender._task.done())):
        if time.monotonic() >= deadline:
            raise TimeoutError(f"send plane to {endpoint} never drained")
        await asyncio.sleep(0.02)


def test_port_loads_its_own_library():
    """The port's transport builds and loads tpuraft_torch/native, never
    the JAX package's native/."""
    assert "TPURAFT_NATIVE_TRANSPORT_LIB" not in os.environ
    lib = native_tcp._load()
    assert os.path.dirname(os.path.realpath(lib._name)) == \
        os.path.realpath(PORT_NATIVE)


class TestNativeRpc:
    async def test_roundtrip_and_error(self):
        srv = await _start_server(NativeTcpRpcServer)

        async def echo(req):
            return ReadIndexResponse(index=req.index, success=True)

        async def boom(req):
            raise RpcError(Status.error(RaftError.EPERM, "not leader"))

        srv.register("echo", echo)
        srv.register("boom", boom)
        t = NativeTcpTransport()
        resp = await t.call(srv.endpoint, "echo", _rir(42))
        assert resp.index == 42 and resp.success
        with pytest.raises(RpcError) as ei:
            await t.call(srv.endpoint, "boom", _rir(0))
        assert ei.value.status.code == int(RaftError.EPERM)
        with pytest.raises(RpcError):
            await t.call(srv.endpoint, "nope", _rir(0))
        resp = await t.call(srv.endpoint, "echo", _rir(7))
        assert resp.index == 7
        await t.close()
        await srv.stop()

    async def test_pipelining_out_of_order_completion(self):
        srv = await _start_server(NativeTcpRpcServer)

        async def slow(req):
            await asyncio.sleep(0.2)
            return ReadIndexResponse(index=req.index, success=True)

        async def fast(req):
            return ReadIndexResponse(index=req.index, success=True)

        srv.register("slow", slow)
        srv.register("fast", fast)
        t = NativeTcpTransport()
        t_slow = asyncio.ensure_future(
            t.call(srv.endpoint, "slow", _rir(1), timeout_ms=2000))
        t_fast = asyncio.ensure_future(t.call(srv.endpoint, "fast", _rir(2)))
        fast_resp = await asyncio.wait_for(t_fast, 0.15)
        assert fast_resp.index == 2
        assert (await t_slow).index == 1
        await t.close()
        await srv.stop()

    async def test_timeout_and_reconnect_after_restart(self):
        srv = await _start_server(NativeTcpRpcServer)
        endpoint = srv.endpoint

        async def hang(req):
            await asyncio.sleep(10)

        async def ok(req):
            return ReadIndexResponse(index=5, success=True)

        srv.register("hang", hang)
        srv.register("ok", ok)
        t = NativeTcpTransport()
        with pytest.raises(RpcError) as ei:
            await t.call(endpoint, "hang", _rir(0), timeout_ms=100)
        assert ei.value.status.code == int(RaftError.ETIMEDOUT)
        await srv.stop()
        with pytest.raises(RpcError):
            await t.call(endpoint, "ok", _rir(0), timeout_ms=300)
        srv2 = NativeTcpRpcServer(endpoint)
        await srv2.start()
        srv2.register("ok", ok)
        # the pool may need one failed call to evict the dead connection
        resp = None
        for _ in range(4):
            try:
                resp = await t.call(endpoint, "ok", _rir(0), timeout_ms=1000)
                break
            except RpcError:
                await asyncio.sleep(0.05)
        assert resp is not None and resp.index == 5
        await t.close()
        await srv2.stop()

    async def test_large_payload(self):
        srv = await _start_server(NativeTcpRpcServer)

        async def echo(req):
            return ReadIndexResponse(index=len(req.data), success=True)

        srv.register("echo", echo)
        t = NativeTcpTransport()
        blob = bytes(range(256)) * (4 * 1024 * 16)  # 4 MB
        resp = await t.call(srv.endpoint, "echo",
                            GetFileResponse(eof=False, data=blob),
                            timeout_ms=5000)
        assert resp.index == len(blob)
        await t.close()
        await srv.stop()

    async def test_many_concurrent_calls(self):
        """Stress the event queue + pipelining: 200 interleaved calls."""
        srv = await _start_server(NativeTcpRpcServer)

        async def echo(req):
            return ReadIndexResponse(index=req.index, success=True)

        srv.register("echo", echo)
        t = NativeTcpTransport()
        results = await asyncio.gather(*[
            t.call(srv.endpoint, "echo", _rir(i), timeout_ms=5000)
            for i in range(200)])
        assert [r.index for r in results] == list(range(200))
        await t.close()
        await srv.stop()


class TestInterop:
    """Wire compatibility both directions."""

    async def test_python_client_native_server(self):
        srv = await _start_server(NativeTcpRpcServer)

        async def echo(req):
            return ReadIndexResponse(index=req.index, success=True)

        srv.register("echo", echo)
        t = TcpTransport()
        resp = await t.call(srv.endpoint, "echo", _rir(99))
        assert resp.index == 99
        await t.close()
        await srv.stop()

    async def test_native_client_python_server(self):
        srv = await _start_server(TcpRpcServer)

        async def echo(req):
            return ReadIndexResponse(index=req.index, success=True)

        srv.register("echo", echo)
        t = NativeTcpTransport()
        resp = await t.call(srv.endpoint, "echo", _rir(123))
        assert resp.index == 123
        await t.close()
        await srv.stop()


class NativeCluster(TcpCluster):
    server_cls = NativeTcpRpcServer
    transport_cls = NativeTcpTransport


class TestRaftOverNativeTransport:
    async def test_elect_replicate_failover(self, tmp_path):
        c = NativeCluster(tmp_path)
        await c.start(3)
        try:
            leader = await c.wait_leader()
            for i in range(5):
                st = await c.apply_ok(leader, b"cmd%d" % i)
                assert st.is_ok(), st
            await c.wait_applied(5)
            dead = leader.server_id
            await c.crash(dead)
            leader2 = await c.wait_leader()
            assert leader2.server_id != dead
            st = await c.apply_ok(leader2, b"after-failover")
            assert st.is_ok(), st
            await c.restart(dead)
            await c.wait_applied(6)
            assert c.fsms[dead].logs[-1] == b"after-failover"
        finally:
            await c.stop_all()


class TestSnapshotInstallOverNativeTransport:
    async def test_install_snapshot_remote_copy(self, tmp_path):
        """InstallSnapshot's chunked remote file copy over the native
        epoll transport: a follower that crashed past the compaction
        horizon pulls the snapshot over real sockets."""
        c = NativeCluster(tmp_path, snapshot=True)
        await c.start(3)
        try:
            leader = await c.wait_leader()
            victim = next(p for p in c.peers if p != leader.server_id)
            st = await c.apply_ok(leader, b"s0")
            assert st.is_ok()
            await c.wait_applied(1)
            await c.crash(victim)
            for i in range(1, 15):
                st = await c.apply_ok(leader, b"s%d" % i)
                assert st.is_ok(), st
            st = await leader.snapshot()
            assert st.is_ok(), str(st)
            assert leader.log_manager.first_log_index() > 1
            await drain_sends_to(leader, victim.endpoint)
            await c.restart(victim)
            await c.wait_applied(15, timeout_s=15)
            assert c.fsms[victim].logs == [b"s%d" % i for i in range(15)]
            assert c.fsms[victim].snapshots_loaded >= 1
        finally:
            await c.stop_all()


class FaultyNativeCluster(NativeCluster):
    """Native-transport cluster with per-node fault injection wrappers."""

    def transport_cls(self, endpoint):  # type: ignore[override]
        from tpuraft_torch.rpc.fault import FaultInjectingTransport

        t = FaultInjectingTransport(NativeTcpTransport(endpoint=endpoint),
                                    seed=len(self.faults) + 1)
        self.faults.append(t)
        return t

    def __init__(self, tmp_path=None, snapshot=False):
        super().__init__(tmp_path, snapshot)
        self.faults = []


class TestAdversarialOverNativeTransport:
    async def test_drops_and_delays_over_real_sockets(self, tmp_path):
        """5% injected drops + 2ms delays on every node's outbound calls
        over the C++ epoll transport; writes keep committing and replicas
        converge exactly-once."""
        c = FaultyNativeCluster(tmp_path)
        await c.start(3)
        try:
            leader = await c.wait_leader()
            for f in c.faults:
                f.set_drop_rate(0.05)
                f.set_delay_ms(2)
            acked = []
            for i in range(40):
                try:
                    st = await c.apply_ok(leader, b"f%03d" % i)
                    if st.is_ok():
                        acked.append(b"f%03d" % i)
                except asyncio.TimeoutError:
                    pass  # counts against the >=30 threshold below
                leader = await c.wait_leader()
            assert len(acked) >= 30, len(acked)
            for f in c.faults:
                f.set_drop_rate(0)
                f.set_delay_ms(0)
            acked_set = set(acked)
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                logs = [c.fsms[p].logs for p in c.peers]
                if (logs[0] == logs[1] == logs[2]
                        and acked_set <= set(logs[0])):
                    break
                await asyncio.sleep(0.1)
            logs = [c.fsms[p].logs for p in c.peers]
            assert logs[0] == logs[1] == logs[2]
            occ = Counter(logs[0])
            for e in acked_set:
                assert occ[e] == 1, (e, occ[e])
        finally:
            await c.stop_all()


# -- the interop differential ---------------------------------------------------

def _seeded_messages(m, seed: int) -> list:
    """Requests of several wire types, each field drawn from the seed,
    built with the message classes of module `m`."""
    rng = np.random.default_rng(seed)

    def blob(n):
        return rng.bytes(int(n))

    out = []
    for i in range(24):
        k = i % 4
        if k == 0:
            out.append(m.ReadIndexResponse(index=int(rng.integers(1 << 40)),
                                           success=bool(rng.integers(2))))
        elif k == 1:
            out.append(m.GetFileResponse(eof=bool(rng.integers(2)),
                                         data=blob(rng.integers(0, 70000))))
        elif k == 2:
            out.append(m.GetFileRequest(
                reader_id=int(rng.integers(1 << 30)),
                filename="f%d" % i, offset=int(rng.integers(1 << 30)),
                count=int(rng.integers(1 << 20))))
        else:
            out.append(m.RequestVoteResponse(
                term=int(rng.integers(1 << 30)),
                granted=bool(rng.integers(2))))
    return out


def _pkg(name: str):
    """One package's wire messages, native transport and errors."""
    if name == "jax":
        import tpuraft.errors as errors
        import tpuraft.rpc.messages as messages
        import tpuraft.rpc.native_tcp as ntcp
    else:
        import tpuraft_torch.errors as errors
        import tpuraft_torch.rpc.messages as messages
        ntcp = native_tcp
    return types.SimpleNamespace(errors=errors, messages=messages, ntcp=ntcp)


async def _serve_echo(pkg):
    """A native server of `pkg` that echoes each request back and fails
    the `boom` method with EPERM."""
    srv = await _start_server(pkg.ntcp.NativeTcpRpcServer)

    async def echo(req):
        return req

    async def boom(req):
        raise pkg.ntcp.RpcError(pkg.errors.Status.error(
            pkg.errors.RaftError.EPERM, "not leader"))

    srv.register("echo", echo)
    srv.register("boom", boom)
    return srv


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("jax", "torch"), ("torch", "jax")])
async def test_interop_differential(client_pkg, server_pkg):
    """One package's native client against the other package's native
    server, both over their own C++ engines: every response decodes to
    the bytes the same client gets from its own package's server, and
    the error status is the same."""
    client = _pkg(client_pkg)
    client.ntcp.ensure_built()
    _pkg(server_pkg).ntcp.ensure_built()
    enc = client.messages.encode_message
    reqs = _seeded_messages(client.messages, seed=7)
    got = {}
    for srv_pkg in (server_pkg, client_pkg):
        srv = await _serve_echo(_pkg(srv_pkg))
        t = client.ntcp.NativeTcpTransport()
        try:
            resps = await asyncio.gather(*[
                t.call(srv.endpoint, "echo", r, timeout_ms=5000)
                for r in reqs])
            with pytest.raises(client.ntcp.RpcError) as ei:
                await t.call(srv.endpoint, "boom", reqs[0])
            got[srv_pkg] = ([enc(r) for r in resps],
                            ei.value.status.code, ei.value.status.error_msg)
        finally:
            await t.close()
            await srv.stop()
    assert got[server_pkg] == got[client_pkg]
    assert got[server_pkg][0] == [enc(r) for r in reqs]
    assert got[server_pkg][1] == int(RaftError.EPERM)
    # both libraries are loaded in this process, each from its own tree
    paths = {os.path.dirname(os.path.realpath(_pkg(n).ntcp._lib._name))
             for n in ("jax", "torch")}
    assert len(paths) == 2 and os.path.realpath(PORT_NATIVE) in paths
