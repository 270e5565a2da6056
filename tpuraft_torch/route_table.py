"""RouteTable: client-side groupId -> (configuration, leader) cache.

Reference parity: ``core:RouteTable`` (``#updateConfiguration``,
``#refreshLeader``, ``#refreshConfiguration``, ``#selectLeader``) —
SURVEY.md §3.1 "Client routing".  A process-local singleton is available
via :func:`RouteTable.instance` to mirror ``RouteTable#getInstance``, but
instances are independently constructible for tests.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.cli_service import CliService
from tpuraft_torch.entity import PeerId
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.rpc.transport import RpcError


class RouteTable:
    _instance: Optional["RouteTable"] = None

    def __init__(self) -> None:
        self._conf: dict[str, Configuration] = {}
        self._leaders: dict[str, PeerId] = {}

    @classmethod
    def instance(cls) -> "RouteTable":
        if cls._instance is None:
            cls._instance = RouteTable()
        return cls._instance

    # -- local cache ops -----------------------------------------------------

    def update_configuration(self, group_id: str,
                             conf: Configuration | str) -> bool:
        if isinstance(conf, str):
            conf = Configuration.parse(conf)
        if not conf.is_valid():
            return False
        self._conf[group_id] = conf.copy()
        return True

    def get_configuration(self, group_id: str) -> Optional[Configuration]:
        c = self._conf.get(group_id)
        return c.copy() if c else None

    def update_leader(self, group_id: str, leader: PeerId | str | None) -> bool:
        if leader is None or (isinstance(leader, str) and not leader):
            self._leaders.pop(group_id, None)
            return True
        if isinstance(leader, str):
            leader = PeerId.parse(leader)
        self._leaders[group_id] = leader
        return True

    def select_leader(self, group_id: str) -> Optional[PeerId]:
        return self._leaders.get(group_id)

    def remove_group(self, group_id: str) -> None:
        self._conf.pop(group_id, None)
        self._leaders.pop(group_id, None)

    # -- remote refresh ------------------------------------------------------

    async def refresh_leader(self, cli: CliService, group_id: str,
                             timeout_ms: float = 3000) -> Status:
        conf = self._conf.get(group_id)
        if conf is None:
            return Status.error(RaftError.ENOENT,
                                f"group {group_id} not in route table")
        try:
            leader = await asyncio.wait_for(
                cli.get_leader(group_id, conf), timeout_ms / 1000.0)
        except asyncio.TimeoutError:
            return Status.error(RaftError.ETIMEDOUT, "refresh_leader timeout")
        if leader is None:
            return Status.error(RaftError.EAGAIN,
                                f"no leader found for {group_id}")
        self._leaders[group_id] = leader
        return Status.OK()

    async def refresh_configuration(self, cli: CliService, group_id: str,
                                    timeout_ms: float = 3000) -> Status:
        conf = self._conf.get(group_id)
        if conf is None:
            return Status.error(RaftError.ENOENT,
                                f"group {group_id} not in route table")
        st = await self.refresh_leader(cli, group_id, timeout_ms)
        if not st.is_ok():
            return st
        try:
            fresh = await asyncio.wait_for(
                cli.get_configuration(group_id, conf), timeout_ms / 1000.0)
        except asyncio.TimeoutError:
            return Status.error(RaftError.ETIMEDOUT,
                                "refresh_configuration timeout")
        except RpcError as e:
            return e.status
        if fresh.is_valid():
            self._conf[group_id] = fresh
        return Status.OK()
