"""L2 RPC / transport (reference: core:rpc/ over SOFABolt/Netty — SURVEY.md §3.1).

Two implementations of one async interface:
  - :class:`tpuraft.rpc.transport.InProcTransport` — loopback, in one
    process, with fault injection (the TestCluster pattern, §5);
  - TCP transport (tpuraft.rpc.tcp_transport) with the binary codec for
    real deployments; the C++/gRPC DCN plane slots in behind the same
    interface.
"""

from tpuraft_torch.rpc.messages import (
    AppendEntriesRequest,
    AppendEntriesResponse,
    RequestVoteRequest,
    RequestVoteResponse,
    InstallSnapshotRequest,
    InstallSnapshotResponse,
    TimeoutNowRequest,
    TimeoutNowResponse,
    ReadIndexRequest,
    ReadIndexResponse,
    GetFileRequest,
    GetFileResponse,
)
from tpuraft_torch.rpc.transport import InProcNetwork, InProcTransport, RpcServer

__all__ = [
    "AppendEntriesRequest",
    "AppendEntriesResponse",
    "RequestVoteRequest",
    "RequestVoteResponse",
    "InstallSnapshotRequest",
    "InstallSnapshotResponse",
    "TimeoutNowRequest",
    "TimeoutNowResponse",
    "ReadIndexRequest",
    "ReadIndexResponse",
    "GetFileRequest",
    "GetFileResponse",
    "InProcNetwork",
    "InProcTransport",
    "RpcServer",
]
