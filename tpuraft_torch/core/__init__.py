"""Consensus core of the port: Node, NodeManager, the user StateMachine
seam, and the MultiRaftEngine (``tpuraft_torch.core.engine``) that
batches every engine-backed group's quorum math into one device tick.

Kept lean: the bootstrap and CLI services are not part of the port yet.
"""

from tpuraft_torch.core.state_machine import (StateMachine,
                                              StateMachineAdapter, Iterator)
from tpuraft_torch.core.node import Node, State
from tpuraft_torch.core.node_manager import NodeManager

__all__ = [
    "StateMachine",
    "StateMachineAdapter",
    "Iterator",
    "Node",
    "State",
    "NodeManager",
]
