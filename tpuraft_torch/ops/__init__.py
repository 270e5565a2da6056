"""Device plane of the port: the batched raft tick as torch code.

``ballot`` holds the quorum math as plain torch ops (the semantic
oracle), ``quorum_cuda`` the fused-quorum CUDA kernel with its plain
version and the loader of the CUDA library, and ``tick`` the whole-tick
function the engine calls (one fused-tick launch on CUDA).  Kernels
build at first use, never at import.
"""

from tpuraft_torch.ops.ballot import (
    NEG_INF_I32,
    joint_quorum_match_index,
    quorum_match_index,
    vote_quorum,
)
from tpuraft_torch.ops.tick import GroupState, TickOutputs, TickParams, raft_tick

__all__ = [
    "quorum_match_index",
    "joint_quorum_match_index",
    "vote_quorum",
    "NEG_INF_I32",
    "GroupState",
    "TickParams",
    "TickOutputs",
    "raft_tick",
]
