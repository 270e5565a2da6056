"""CLI (admin) RPC messages.

Reference parity: generated ``core:rpc/CliRequests`` protobuf — one
request/response pair per admin op (AddPeer, RemovePeer, ChangePeers,
ResetPeer, Snapshot, TransferLeader, GetLeader, GetPeers, AddLearners,
RemoveLearners) — handled server-side by the per-op processors under
``core:rpc/impl/cli/`` (SURVEY.md §3.1 "CLI service & processors").

All requests carry ``group_id`` (multi-raft routing key) and ``peer_id``
(the serving peer; empty string = "whichever node of this group lives on
the addressed endpoint").  Peers travel as ``str`` in PeerId's canonical
``ip:port[:idx[:priority]]`` form.  Type ids 64+ in the shared codec.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpuraft_torch.rpc.messages import register_message


def _cli(tid: int):
    def deco(cls):
        return register_message(tid, dataclass(cls))
    return deco


@_cli(64)
class GetLeaderRequest:
    group_id: str
    peer_id: str = ""


@_cli(65)
class GetLeaderResponse:
    leader_id: str = ""
    success: bool = True


@_cli(66)
class GetPeersRequest:
    group_id: str
    peer_id: str = ""
    only_alive: bool = False


@_cli(67)
class GetPeersResponse:
    peers: list[str] = field(default_factory=list)
    learners: list[str] = field(default_factory=list)
    success: bool = True
    # trailing extension (witness replicas): voters that are witnesses
    # (subset of ``peers``); old clients ignore it
    witnesses: list[str] = field(default_factory=list)


@_cli(68)
class AddPeerRequest:
    group_id: str
    peer_id: str
    adding: str = ""
    # trailing extension: add the voter as a WITNESS (metadata-only
    # replica); old servers ignore the flag and add a full voter
    witness: bool = False


@_cli(69)
class RemovePeerRequest:
    group_id: str
    peer_id: str
    removing: str = ""


@_cli(70)
class ChangePeersRequest:
    group_id: str
    peer_id: str
    new_peers: list[str] = field(default_factory=list)      # voters
    new_learners: list[str] = field(default_factory=list)
    # trailing extension: which of new_peers are witnesses
    new_witnesses: list[str] = field(default_factory=list)


@_cli(71)
class ResetPeersRequest:
    group_id: str
    peer_id: str
    new_peers: list[str] = field(default_factory=list)      # voters
    new_learners: list[str] = field(default_factory=list)
    # trailing extension: which of new_peers are witnesses
    new_witnesses: list[str] = field(default_factory=list)


@_cli(72)
class SnapshotRequest:
    group_id: str
    peer_id: str = ""


@_cli(73)
class TransferLeaderRequest:
    group_id: str
    peer_id: str
    transferee: str = ""


@_cli(74)
class AddLearnersRequest:
    group_id: str
    peer_id: str
    learners: list[str] = field(default_factory=list)


@_cli(75)
class RemoveLearnersRequest:
    group_id: str
    peer_id: str
    learners: list[str] = field(default_factory=list)


@_cli(77)
class ResetLearnersRequest:
    group_id: str
    peer_id: str
    learners: list[str] = field(default_factory=list)


@_cli(78)
class DescribeMetricsRequest:
    """Live-metrics scrape over the wire (observability plane): the
    addressed STORE answers with its Prometheus text rendering — the
    same content its optional HTTP /metrics listener serves, reachable
    through the admin transport without signals or extra ports."""

    # reserved scope selector (""=whole store); trailing-compatible
    scope: str = ""


@_cli(79)
class DescribeMetricsResponse:
    text: str = ""
    success: bool = True


@_cli(76)
class CliResponse:
    """Uniform admin-op outcome: ok/error code/msg + new conf if changed."""

    code: int = 0
    msg: str = ""
    old_peers: list[str] = field(default_factory=list)
    new_peers: list[str] = field(default_factory=list)

    @property
    def success(self) -> bool:
        return self.code == 0
