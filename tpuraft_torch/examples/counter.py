"""Counter: the canonical single-group raft application.

Reference parity: ``example:counter/CounterServer`` / ``CounterClient`` /
``CounterStateMachine`` / ``CounterServiceImpl`` + its request processors
(SURVEY.md §3.3) — a replicated 64-bit counter where ``increment_and_get``
goes through ``Node#apply`` and ``get`` uses the linearizable readIndex
barrier instead of the log.

Run a member (3-process cluster over TCP):
    python -m examples.counter --serve 127.0.0.1:8081 \
        --peers 127.0.0.1:8081,127.0.0.1:8082,127.0.0.1:8083 --data /tmp/c1
Run the client against it:
    python -m examples.counter --incr 5 \
        --peers 127.0.0.1:8081,127.0.0.1:8082,127.0.0.1:8083
Or the self-contained demo (3 nodes in one process, leader kill included):
    python -m examples.counter
"""

from __future__ import annotations

import argparse
import asyncio
import struct
from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.cli_service import CliProcessors, CliService
from tpuraft_torch.core.node import Node
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.core.raft_group_service import RaftGroupService
from tpuraft_torch.core.state_machine import Iterator, StateMachine
from tpuraft_torch.entity import PeerId, Task
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.options import NodeOptions
from tpuraft_torch.route_table import RouteTable
from tpuraft_torch.rpc.messages import register_message


def _msg(tid: int):
    def deco(cls):
        from dataclasses import dataclass as dc
        return register_message(tid, dc(cls))
    return deco
from tpuraft_torch.rpc.tcp import TcpRpcServer, TcpTransport
from tpuraft_torch.rpc.transport import RpcError

GROUP = "counter"


# -- wire messages (example type-id range 240+) ------------------------------

@_msg(240)
class IncrementAndGetRequest:
    delta: int = 1


@_msg(241)
class GetValueRequest:
    linearizable: bool = True


@_msg(242)
class ValueResponse:
    success: bool = False
    value: int = 0
    redirect: str = ""


class CounterStateMachine(StateMachine):
    """Applies 8-byte little-endian deltas; snapshots the running value."""

    def __init__(self) -> None:
        self.value = 0
        self.leader_term = -1

    async def on_apply(self, it: Iterator) -> None:
        while it.valid():
            (delta,) = struct.unpack("<q", it.data())
            self.value += delta
            done = it.done()
            if done is not None:
                # closures take Status only; the computed value rides as an
                # attribute (reference: CounterClosure#setValue before run)
                done.result_value = self.value
                done(Status.OK())
            it.next()

    async def on_leader_start(self, term: int) -> None:
        self.leader_term = term

    async def on_leader_stop(self, status: Status) -> None:
        self.leader_term = -1

    async def on_snapshot_save(self, writer, done) -> None:
        writer.write_file("counter", struct.pack("<q", self.value))
        done(Status.OK())

    async def on_snapshot_load(self, reader) -> bool:
        blob = reader.read_file("counter")
        if blob is None:
            return False
        (self.value,) = struct.unpack("<q", blob)
        return True


class CounterServer:
    """One cluster member: raft node + the counter RPC service on one port
    (reference: CounterServer boots RaftGroupService and registers the
    counter processors on the shared RpcServer)."""

    def __init__(self, me: PeerId, conf: Configuration, data_dir: str | None,
                 config_yaml: str | None = None):
        self.me = me
        self.conf = conf
        self.fsm = CounterStateMachine()
        self.server = TcpRpcServer(me.endpoint)
        self.manager = NodeManager(self.server)
        self.transport = TcpTransport(endpoint=me.endpoint)
        self.node: Node | None = None
        self.data_dir = data_dir
        self.config_yaml = config_yaml

    async def start(self) -> None:
        await self.server.start()
        CliProcessors(self.manager)
        if self.config_yaml:
            # tunables from YAML (SURVEY §6 config layer); topology and
            # storage placement come from the CLI here, so a YAML that
            # also sets them is a CONFLICT, not a silent override
            from tpuraft_torch.config import load_node_options

            opts = load_node_options(self.config_yaml)
            # storage placement and topology always come from the CLI
            # here (--data / --peers), so YAML settings for them would
            # be silently clobbered below — reject them loudly instead
            conflicts = [name for name, dflt in [
                ("initial_conf", Configuration()),
                ("fsm", None)] if getattr(opts, name) != dflt]
            conflicts += [n for n in ("log_uri", "raft_meta_uri",
                                      "snapshot_uri")
                          if getattr(opts, n)]
            if conflicts:
                raise SystemExit(
                    f"--config sets {conflicts}, which --peers/--data "
                    f"control on the counter CLI — remove them from "
                    f"the YAML or drop the flags")
        else:
            opts = NodeOptions()
        opts.initial_conf = self.conf.copy()
        opts.fsm = self.fsm
        if self.data_dir:
            opts.log_uri = f"file://{self.data_dir}/log"
            opts.raft_meta_uri = f"file://{self.data_dir}/meta"
            opts.snapshot_uri = f"file://{self.data_dir}/snapshot"
        else:
            opts.log_uri = "memory://"
            opts.raft_meta_uri = "memory://"
        svc = RaftGroupService(GROUP, self.me, opts, self.manager,
                               self.transport)
        self.node = await svc.start()
        self.server.register("counter_incr", self._handle_incr)
        self.server.register("counter_get", self._handle_get)

    async def stop(self) -> None:
        if self.node:
            await self.node.shutdown()
        await self.transport.close()
        await self.server.stop()

    # -- service handlers (reference: IncrementAndGetRequestProcessor etc) --

    def _redirect(self) -> ValueResponse:
        leader = self.node.leader_id if self.node else None
        return ValueResponse(success=False, value=0,
                             redirect=str(leader) if leader else "")

    async def _handle_incr(self, req: IncrementAndGetRequest) -> ValueResponse:
        if self.node is None or not self.node.is_leader():
            return self._redirect()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()

        def done(st: Status):
            if not fut.done():
                fut.set_result((st, getattr(done, "result_value", None)))

        await self.node.apply(Task(data=struct.pack("<q", req.delta),
                                   done=done))
        st, value = await fut
        if not st.is_ok():
            return self._redirect()
        return ValueResponse(success=True, value=value)

    async def _handle_get(self, req: GetValueRequest) -> ValueResponse:
        if self.node is None:
            return self._redirect()
        if not req.linearizable:
            return ValueResponse(success=True, value=self.fsm.value)
        try:
            await self.node.read_index()  # waits until applied >= readIndex
        except Exception:  # noqa: BLE001 — no quorum / not leader
            return self._redirect()
        return ValueResponse(success=True, value=self.fsm.value)


class CounterClient:
    """Leader-finding client with redirect-following retry (reference:
    CounterClient over CliClientService + RouteTable)."""

    def __init__(self, conf: Configuration, transport=None):
        self.conf = conf
        self.transport = transport or TcpTransport()
        self.route_table = RouteTable()
        self.route_table.update_configuration(GROUP, conf)
        self.cli = CliService(self.transport)
        self._leader: PeerId | None = None

    async def _find_leader(self) -> PeerId:
        if self._leader is not None:
            return self._leader
        st = await self.route_table.refresh_leader(self.cli, GROUP)
        leader = self.route_table.select_leader(GROUP)
        if not st.is_ok() or leader is None:
            raise RpcError(Status.error(RaftError.EPERM, f"no leader: {st}"))
        self._leader = leader
        return leader

    async def _call(self, method: str, req, retries: int = 40):
        last: Exception | None = None
        for _ in range(retries):
            try:
                leader = await self._find_leader()
                resp = await self.transport.call(leader.endpoint, method, req,
                                                 2000)
            except RpcError as e:
                # dead/electing cluster: a re-election takes a few election
                # timeouts, so the retry budget must span several seconds
                last = e
                self._leader = None
                await asyncio.sleep(0.15)
                continue
            if resp.success:
                return resp.value
            self._leader = (PeerId.parse(resp.redirect)
                            if resp.redirect else None)
            await asyncio.sleep(0.05 if resp.redirect else 0.2)
        raise last or TimeoutError(f"{method}: retries exhausted")

    async def increment_and_get(self, delta: int = 1) -> int:
        return await self._call("counter_incr", IncrementAndGetRequest(delta))

    async def get(self, linearizable: bool = True) -> int:
        return await self._call("counter_get", GetValueRequest(linearizable))


# -- demo / main -------------------------------------------------------------

async def demo(n: int = 3, increments: int = 10, data_root: str | None = None,
               verbose: bool = True) -> int:
    """Self-contained: n servers in one process over TCP, client traffic,
    leader crash, recovery. Returns the final counter value."""
    servers: list[CounterServer] = []
    for _ in range(n):
        srv = TcpRpcServer("127.0.0.1:0")
        await srv.start()
        srv.endpoint = f"127.0.0.1:{srv.bound_port}"
        await srv.stop()
        servers.append(srv)  # placeholder for port reservation
    peers = [PeerId.parse(s.endpoint) for s in servers]
    conf = Configuration(list(peers))
    members = []
    for i, p in enumerate(peers):
        m = CounterServer(
            p, conf, f"{data_root}/{p.port}" if data_root else None)
        await m.start()
        members.append(m)

    def say(*a):
        if verbose:
            print(*a)

    # wait for the first election before driving traffic
    for _ in range(400):
        if any(m.node and m.node.is_leader() for m in members):
            break
        await asyncio.sleep(0.025)

    client = CounterClient(conf)
    try:
        for i in range(increments):
            v = await client.increment_and_get()
            say(f"increment -> {v}")
        v = await client.get()
        say(f"linearizable get -> {v}")
        assert v == increments
        # crash the leader; the cluster recovers and serves again
        leader = next(m for m in members if m.node and m.node.is_leader())
        say(f"crashing leader {leader.me} ...")
        await leader.stop()
        members.remove(leader)
        client._leader = None
        v = await client.increment_and_get(5)
        say(f"after failover: increment 5 -> {v}")
        assert v == increments + 5
        return v
    finally:
        await client.transport.close()
        for m in members:
            await m.stop()


async def _serve(args) -> None:
    conf = Configuration.parse(args.peers)
    server = CounterServer(PeerId.parse(args.serve), conf, args.data,
                           config_yaml=args.config)
    await server.start()
    print(f"counter member {args.serve} up (group={GROUP})")
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await server.stop()


async def _client(args) -> None:
    conf = Configuration.parse(args.peers)
    client = CounterClient(conf)
    try:
        if args.incr:
            print(await client.increment_and_get(args.incr))
        else:
            print(await client.get())
    finally:
        await client.transport.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--serve", help="ip:port to serve as a cluster member")
    ap.add_argument("--peers", help="comma-separated cluster conf")
    ap.add_argument("--data", help="data dir (omit for in-memory)")
    ap.add_argument("--config", help="YAML options file (tpuraft.config)")
    ap.add_argument("--incr", type=int, help="client: increment by N")
    ap.add_argument("--get", action="store_true", help="client: read value")
    args = ap.parse_args()
    if args.serve:
        asyncio.run(_serve(args))
    elif args.incr or args.get:
        asyncio.run(_client(args))
    else:
        asyncio.run(demo())


if __name__ == "__main__":
    main()
