"""Leader election only — no replicated data.

Reference parity: ``example:election/*`` (SURVEY.md §3.3, ``[1.3+]``): use
a raft group purely as an election service; the state machine only cares
about ``on_leader_start`` / ``on_leader_stop``.  Common pattern for HA
singletons (schedulers, PD-style controllers).

    python -m examples.election          # in-process demo w/ leader kill
    python -m examples.election --serve 127.0.0.1:8081 \
        --peers 127.0.0.1:8081,127.0.0.1:8082,127.0.0.1:8083
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Callable, Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.cli_service import CliProcessors
from tpuraft_torch.core.node import Node
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.core.raft_group_service import RaftGroupService
from tpuraft_torch.core.state_machine import Iterator, StateMachine
from tpuraft_torch.entity import PeerId
from tpuraft_torch.options import NodeOptions
from tpuraft_torch.rpc.tcp import TcpRpcServer, TcpTransport

GROUP = "election"


class ElectionOnlyStateMachine(StateMachine):
    """Only the leadership callbacks matter (reference:
    ElectionOnlyStateMachine)."""

    def __init__(self,
                 on_start: Optional[Callable[[int], None]] = None,
                 on_stop: Optional[Callable[[], None]] = None):
        self.is_leader = False
        self.leader_term = -1
        self._on_start = on_start
        self._on_stop = on_stop

    async def on_apply(self, it: Iterator) -> None:
        while it.valid():  # only no-op/conf entries ever arrive
            it.next()

    async def on_leader_start(self, term: int) -> None:
        self.is_leader = True
        self.leader_term = term
        if self._on_start:
            self._on_start(term)

    async def on_leader_stop(self, status) -> None:
        self.is_leader = False
        if self._on_stop:
            self._on_stop()


class ElectionNode:
    """One election-service member on a TCP endpoint."""

    def __init__(self, me: PeerId, conf: Configuration,
                 fsm: Optional[ElectionOnlyStateMachine] = None,
                 election_timeout_ms: int = 1000):
        self.me = me
        self.conf = conf
        self.fsm = fsm or ElectionOnlyStateMachine()
        self.election_timeout_ms = election_timeout_ms
        self.server = TcpRpcServer(me.endpoint)
        self.transport = TcpTransport(endpoint=me.endpoint)
        self.node: Node | None = None

    async def start(self) -> None:
        await self.server.start()
        manager = NodeManager(self.server)
        CliProcessors(manager)
        opts = NodeOptions(
            election_timeout_ms=self.election_timeout_ms,
            initial_conf=self.conf.copy(), fsm=self.fsm,
            log_uri="memory://", raft_meta_uri="memory://")
        svc = RaftGroupService(GROUP, self.me, opts, manager, self.transport)
        self.node = await svc.start()

    async def stop(self) -> None:
        if self.node:
            await self.node.shutdown()
        await self.transport.close()
        await self.server.stop()


async def demo(n: int = 3, verbose: bool = True) -> tuple[str, str]:
    """Start n members, observe a leader emerge, kill it, observe the
    next. Returns (first_leader, second_leader) endpoints."""
    def say(*a):
        if verbose:
            print(*a)

    ports = []
    for _ in range(n):
        srv = TcpRpcServer("127.0.0.1:0")
        await srv.start()
        ports.append(srv.bound_port)
        await srv.stop()
    peers = [PeerId.parse(f"127.0.0.1:{p}") for p in ports]
    conf = Configuration(list(peers))
    members = []
    for p in peers:
        fsm = ElectionOnlyStateMachine(
            on_start=lambda term, p=p: say(f"  {p} became leader (term {term})"),
            on_stop=lambda p=p: say(f"  {p} lost leadership"))
        m = ElectionNode(p, conf, fsm, election_timeout_ms=400)
        await m.start()
        members.append(m)

    async def wait_leader() -> ElectionNode:
        for _ in range(600):
            live = [m for m in members if m.node]
            leaders = [m for m in live if m.node.is_leader()]
            if len(leaders) == 1:
                return leaders[0]
            await asyncio.sleep(0.02)
        raise TimeoutError("no leader")

    try:
        first = await wait_leader()
        say(f"leader: {first.me}")
        say("killing it ...")
        dead = first.me
        await first.stop()
        members.remove(first)
        second = await wait_leader()
        say(f"new leader: {second.me}")
        assert second.me != dead
        return str(dead), str(second.me)
    finally:
        for m in members:
            await m.stop()


async def _serve(args) -> None:
    conf = Configuration.parse(args.peers)
    me = PeerId.parse(args.serve)
    fsm = ElectionOnlyStateMachine(
        on_start=lambda term: print(f"*** I ({me}) am leader, term={term}"),
        on_stop=lambda: print(f"*** I ({me}) lost leadership"))
    node = ElectionNode(me, conf, fsm)
    await node.start()
    print(f"election member {me} up")
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await node.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--serve", help="ip:port to serve as a member")
    ap.add_argument("--peers", help="comma-separated cluster conf")
    args = ap.parse_args()
    if args.serve:
        asyncio.run(_serve(args))
    else:
        asyncio.run(demo())


if __name__ == "__main__":
    main()
