"""Consensus core of the port: Node, NodeManager, RaftGroupService
(bootstrap), the user StateMachine seam, and the MultiRaftEngine
(``tpuraft_torch.core.engine``) that batches every engine-backed group's
quorum math into one device tick.
"""

from tpuraft_torch.core.state_machine import (StateMachine,
                                              StateMachineAdapter, Iterator)
from tpuraft_torch.core.node import Node, State
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.core.raft_group_service import RaftGroupService

__all__ = [
    "StateMachine",
    "StateMachineAdapter",
    "Iterator",
    "Node",
    "State",
    "NodeManager",
    "RaftGroupService",
]
