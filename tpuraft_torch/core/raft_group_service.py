"""RaftGroupService: boot one raft group member on a shared endpoint.

Reference parity: ``core:RaftGroupService`` (SURVEY.md §4.1).
"""

from __future__ import annotations

from tpuraft_torch.core.node import Node
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.entity import PeerId
from tpuraft_torch.options import NodeOptions


class RaftGroupService:
    def __init__(self, group_id: str, server_id: PeerId, options: NodeOptions,
                 node_manager: NodeManager, transport,
                 ballot_box_factory=None):
        self.group_id = group_id
        self.server_id = server_id
        self.options = options
        self.node_manager = node_manager
        self.transport = transport
        self.ballot_box_factory = ballot_box_factory
        self.node: Node | None = None

    async def start(self) -> Node:
        node = Node(self.group_id, self.server_id, self.options, self.transport,
                    ballot_box_factory=self.ballot_box_factory)
        node.node_manager = self.node_manager  # for snapshot file service
        self.node_manager.add(node)
        ok = await node.init()
        if not ok:
            self.node_manager.remove(node)
            raise RuntimeError(f"node init failed: {node}")
        self.node = node
        return node

    async def join(self) -> None:
        """Block until the node has fully shut down (reference:
        RaftGroupService#join)."""
        if self.node is not None:
            await self.node.join()

    async def shutdown(self) -> None:
        if self.node:
            await self.node.shutdown()
            self.node_manager.remove(self.node)
            self.node = None
