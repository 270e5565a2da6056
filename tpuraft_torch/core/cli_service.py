"""CLI (admin) service: server-side processors + client-side CliService.

Reference parity (SURVEY.md §3.1 "CLI service & processors"):
server side = ``core:rpc/impl/cli/*RequestProcessor`` (one per admin op,
all extending ``BaseCliRequestProcessor`` which resolves groupId→Node and
rejects non-leaders); client side = ``core:core/CliServiceImpl`` +
``core:rpc/impl/cli/CliClientServiceImpl`` — each op locates the group
leader (refreshing on redirect), issues the RPC, retries boundedly.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.node import Node
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.entity import PeerId
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.options import CliOptions
from tpuraft_torch.rpc.cli_messages import (
    AddLearnersRequest,
    AddPeerRequest,
    ChangePeersRequest,
    CliResponse,
    DescribeMetricsRequest,
    GetLeaderRequest,
    GetLeaderResponse,
    GetPeersRequest,
    GetPeersResponse,
    RemoveLearnersRequest,
    RemovePeerRequest,
    ResetLearnersRequest,
    ResetPeersRequest,
    SnapshotRequest,
    TransferLeaderRequest,
)
from tpuraft_torch.rpc.transport import RpcError

LOG = logging.getLogger(__name__)


# ---- server side -----------------------------------------------------------


class CliProcessors:
    """Registers one handler per admin op on the shared RpcServer.

    Reference: BaseCliRequestProcessor subclasses bound by
    ``RaftRpcServerFactory#addRaftRequestProcessors``.
    """

    def __init__(self, node_manager: NodeManager):
        self._nm = node_manager
        s = node_manager.server
        s.register("cli_get_leader", self._get_leader)
        s.register("cli_get_peers", self._get_peers)
        s.register("cli_add_peer", self._add_peer)
        s.register("cli_remove_peer", self._remove_peer)
        s.register("cli_change_peers", self._change_peers)
        s.register("cli_reset_peers", self._reset_peers)
        s.register("cli_snapshot", self._snapshot)
        s.register("cli_transfer_leader", self._transfer_leader)
        s.register("cli_add_learners", self._add_learners)
        s.register("cli_remove_learners", self._remove_learners)
        s.register("cli_reset_learners", self._reset_learners)

    def _find(self, group_id: str, peer_id: str) -> Optional[Node]:
        if peer_id:
            return self._nm.get(group_id, peer_id)
        for n in self._nm.list_nodes():
            if n.group_id == group_id:
                return n
        return None

    def _leader_node(self, req) -> tuple[Optional[Node], Optional[CliResponse]]:
        node = self._find(req.group_id, req.peer_id)
        if node is None:
            return None, CliResponse(
                code=int(RaftError.ENOENT),
                msg=f"no node for group {req.group_id} here")
        if not node.is_leader():
            leader = node.get_leader_id()
            return None, CliResponse(
                code=int(RaftError.EPERM),
                msg=f"not leader; leader={leader if leader else '?'}")
        return node, None

    @staticmethod
    def _from_status(st: Status, node: Optional[Node] = None) -> CliResponse:
        resp = CliResponse(code=st.code, msg=st.error_msg)
        if node is not None:
            resp.new_peers = [str(p) for p in node.list_peers()]
        return resp

    async def _get_leader(self, req: GetLeaderRequest) -> GetLeaderResponse:
        node = self._find(req.group_id, req.peer_id)
        if node is None:
            return GetLeaderResponse(leader_id="", success=False)
        leader = node.get_leader_id()
        return GetLeaderResponse(
            leader_id=str(leader) if leader and not leader.is_empty() else "",
            success=bool(leader) and not leader.is_empty())

    async def _get_peers(self, req: GetPeersRequest) -> GetPeersResponse:
        # membership queries must come from the leader — a deposed node
        # would answer with a stale (or, for only_alive, empty) view
        # (reference: GetPeersRequestProcessor requires leadership)
        node = self._find(req.group_id, req.peer_id)
        if node is None or not node.is_leader():
            return GetPeersResponse(success=False)
        peers = (node.list_alive_peers() if req.only_alive
                 else node.list_peers())
        return GetPeersResponse(
            peers=[str(p) for p in peers],
            learners=[str(p) for p in node.list_learners()],
            witnesses=[str(p) for p in node.conf_entry.conf.witnesses])

    async def _add_peer(self, req: AddPeerRequest) -> CliResponse:
        node, err = self._leader_node(req)
        if err:
            return err
        old = [str(p) for p in node.list_peers()]
        st = await node.add_peer(PeerId.parse(req.adding),
                                 witness=bool(getattr(req, "witness", False)))
        resp = self._from_status(st, node)
        resp.old_peers = old
        return resp

    async def _remove_peer(self, req: RemovePeerRequest) -> CliResponse:
        node, err = self._leader_node(req)
        if err:
            return err
        old = [str(p) for p in node.list_peers()]
        st = await node.remove_peer(PeerId.parse(req.removing))
        resp = self._from_status(st, node)
        resp.old_peers = old
        return resp

    async def _change_peers(self, req: ChangePeersRequest) -> CliResponse:
        node, err = self._leader_node(req)
        if err:
            return err
        old = [str(p) for p in node.list_peers()]
        conf = Configuration([PeerId.parse(p) for p in req.new_peers],
                             [PeerId.parse(p) for p in req.new_learners],
                             [PeerId.parse(p) for p in req.new_witnesses])
        st = await node.change_peers(conf)
        resp = self._from_status(st, node)
        resp.old_peers = old
        return resp

    async def _reset_peers(self, req: ResetPeersRequest) -> CliResponse:
        # resetPeers is a last-resort op allowed on non-leaders (reference:
        # ResetPeerRequestProcessor does not require leadership).
        node = self._find(req.group_id, req.peer_id)
        if node is None:
            return CliResponse(code=int(RaftError.ENOENT),
                               msg=f"no node for group {req.group_id} here")
        conf = Configuration([PeerId.parse(p) for p in req.new_peers],
                             [PeerId.parse(p) for p in req.new_learners],
                             [PeerId.parse(p) for p in req.new_witnesses])
        st = await node.reset_peers(conf)
        return self._from_status(st, node)

    async def _snapshot(self, req: SnapshotRequest) -> CliResponse:
        node = self._find(req.group_id, req.peer_id)
        if node is None:
            return CliResponse(code=int(RaftError.ENOENT),
                               msg=f"no node for group {req.group_id} here")
        st = await node.snapshot()
        return self._from_status(st)

    async def _transfer_leader(self, req: TransferLeaderRequest) -> CliResponse:
        node, err = self._leader_node(req)
        if err:
            return err
        st = await node.transfer_leadership_to(PeerId.parse(req.transferee))
        return self._from_status(st, node)

    async def _add_learners(self, req: AddLearnersRequest) -> CliResponse:
        node, err = self._leader_node(req)
        if err:
            return err
        st = await node.add_learners([PeerId.parse(p) for p in req.learners])
        return self._from_status(st, node)

    async def _remove_learners(self, req: RemoveLearnersRequest) -> CliResponse:
        node, err = self._leader_node(req)
        if err:
            return err
        st = await node.remove_learners([PeerId.parse(p) for p in req.learners])
        return self._from_status(st, node)

    async def _reset_learners(self, req: ResetLearnersRequest) -> CliResponse:
        node, err = self._leader_node(req)
        if err:
            return err
        st = await node.reset_learners([PeerId.parse(p) for p in req.learners])
        return self._from_status(st, node)


# ---- client side -----------------------------------------------------------


class CliService:
    """Admin client: locates the leader, issues the op, retries on redirect.

    Reference: ``core:core/CliServiceImpl`` (ops) over
    ``CliClientServiceImpl`` (RPC + connection mgmt).  ``transport`` is any
    object with ``call(dst_endpoint, method, request, timeout_ms)``.
    """

    def __init__(self, transport, options: Optional[CliOptions] = None):
        self._transport = transport
        self._opts = options or CliOptions()
        # groupId -> cached leader PeerId
        self._leaders: dict[str, PeerId] = {}

    # -- leader discovery ----------------------------------------------------

    async def get_leader(self, group_id: str, conf: Configuration
                         ) -> Optional[PeerId]:
        """Ask each configured peer who leads; first definite answer wins."""
        for peer in conf.list_all():
            try:
                resp = await self._transport.call(
                    peer.endpoint, "cli_get_leader",
                    GetLeaderRequest(group_id=group_id, peer_id=str(peer)),
                    self._opts.timeout_ms)
            except RpcError:
                continue
            if resp.success and resp.leader_id:
                leader = PeerId.parse(resp.leader_id)
                self._leaders[group_id] = leader
                return leader
        return None

    async def get_peers(self, group_id: str, conf: Configuration,
                        only_alive: bool = False) -> list[PeerId]:
        resp = await self._peers_rpc(group_id, conf, only_alive)
        return [PeerId.parse(p) for p in resp.peers]

    async def get_learners(self, group_id: str, conf: Configuration
                           ) -> list[PeerId]:
        resp = await self._peers_rpc(group_id, conf, False)
        return [PeerId.parse(p) for p in resp.learners]

    async def get_configuration(self, group_id: str, conf: Configuration
                                ) -> Configuration:
        """Voters, learners AND witness flags in one round trip."""
        resp = await self._peers_rpc(group_id, conf, False)
        return Configuration(
            [PeerId.parse(p) for p in resp.peers],
            [PeerId.parse(p) for p in resp.learners],
            [PeerId.parse(p) for p in getattr(resp, "witnesses", [])])

    async def _peers_rpc(self, group_id: str, conf: Configuration,
                         only_alive: bool) -> GetPeersResponse:
        leader = await self._require_leader(group_id, conf)
        try:
            resp = await self._transport.call(
                leader.endpoint, "cli_get_peers",
                GetPeersRequest(group_id=group_id, peer_id=str(leader),
                                only_alive=only_alive),
                self._opts.timeout_ms)
        except RpcError:
            self._leaders.pop(group_id, None)  # dead leader: force rediscovery
            raise
        if not resp.success:
            self._leaders.pop(group_id, None)
            raise RpcError(Status.error(RaftError.EINTERNAL, "get_peers failed"))
        return resp

    async def _require_leader(self, group_id: str, conf: Configuration
                              ) -> PeerId:
        leader = self._leaders.get(group_id)
        if leader is None:
            leader = await self.get_leader(group_id, conf)
        if leader is None:
            raise RpcError(Status.error(
                RaftError.EAGAIN, f"no leader for group {group_id}"))
        return leader

    # -- admin ops -----------------------------------------------------------

    async def add_peer(self, group_id: str, conf: Configuration,
                       peer: PeerId, witness: bool = False) -> Status:
        return await self._leader_op(
            group_id, conf, "cli_add_peer",
            lambda leader: AddPeerRequest(
                group_id=group_id, peer_id=str(leader), adding=str(peer),
                witness=witness))

    async def add_witness(self, group_id: str, conf: Configuration,
                          peer: PeerId) -> Status:
        """Add a WITNESS voter: votes + acks metadata appends, stores no
        log payload, never leads — a 2+1 geo topology's cheap third
        vote (docs/operations.md "Geo deployment runbook")."""
        return await self.add_peer(group_id, conf, peer, witness=True)

    async def remove_witness(self, group_id: str, conf: Configuration,
                             peer: PeerId) -> Status:
        """Remove a witness voter (same wire op as remove_peer; named
        for operator symmetry with add_witness)."""
        return await self.remove_peer(group_id, conf, peer)

    async def remove_peer(self, group_id: str, conf: Configuration,
                          peer: PeerId) -> Status:
        return await self._leader_op(
            group_id, conf, "cli_remove_peer",
            lambda leader: RemovePeerRequest(
                group_id=group_id, peer_id=str(leader), removing=str(peer)))

    async def change_peers(self, group_id: str, conf: Configuration,
                           new_conf: Configuration) -> Status:
        return await self._leader_op(
            group_id, conf, "cli_change_peers",
            lambda leader: ChangePeersRequest(
                group_id=group_id, peer_id=str(leader),
                new_peers=[str(p) for p in new_conf.peers],
                new_learners=[str(p) for p in new_conf.learners],
                new_witnesses=[str(p) for p in new_conf.witnesses]))

    async def reset_peers(self, group_id: str, peer: PeerId,
                          new_conf: Configuration) -> Status:
        """Directly reset one peer's conf (dangerous; quorum-loss recovery)."""
        resp = await self._transport.call(
            peer.endpoint, "cli_reset_peers",
            ResetPeersRequest(
                group_id=group_id, peer_id=str(peer),
                new_peers=[str(p) for p in new_conf.peers],
                new_learners=[str(p) for p in new_conf.learners],
                new_witnesses=[str(p) for p in new_conf.witnesses]),
            self._opts.timeout_ms)
        return Status(resp.code, resp.msg)

    async def snapshot(self, group_id: str, peer: PeerId) -> Status:
        resp = await self._transport.call(
            peer.endpoint, "cli_snapshot",
            SnapshotRequest(group_id=group_id, peer_id=str(peer)),
            self._opts.timeout_ms)
        return Status(resp.code, resp.msg)

    async def transfer_leader(self, group_id: str, conf: Configuration,
                              transferee: PeerId) -> Status:
        st = await self._leader_op(
            group_id, conf, "cli_transfer_leader",
            lambda leader: TransferLeaderRequest(
                group_id=group_id, peer_id=str(leader),
                transferee=str(transferee)))
        if st.is_ok():
            self._leaders.pop(group_id, None)
        return st

    async def add_learners(self, group_id: str, conf: Configuration,
                           learners: list[PeerId]) -> Status:
        return await self._leader_op(
            group_id, conf, "cli_add_learners",
            lambda leader: AddLearnersRequest(
                group_id=group_id, peer_id=str(leader),
                learners=[str(p) for p in learners]))

    async def remove_learners(self, group_id: str, conf: Configuration,
                              learners: list[PeerId]) -> Status:
        return await self._leader_op(
            group_id, conf, "cli_remove_learners",
            lambda leader: RemoveLearnersRequest(
                group_id=group_id, peer_id=str(leader),
                learners=[str(p) for p in learners]))

    async def reset_learners(self, group_id: str, conf: Configuration,
                             learners: list[PeerId]) -> Status:
        return await self._leader_op(
            group_id, conf, "cli_reset_learners",
            lambda leader: ResetLearnersRequest(
                group_id=group_id, peer_id=str(leader),
                learners=[str(p) for p in learners]))

    async def describe_metrics(self, endpoint: str) -> str:
        """Scrape one store's live metrics (Prometheus text) over the
        admin transport — the wire-borne equivalent of GET /metrics on
        its optional HTTP listener.  Addressed per ENDPOINT (store
        scope, not group scope): every region group on the store is
        folded into the one rendering."""
        resp = await self._transport.call(
            endpoint, "cli_describe_metrics", DescribeMetricsRequest(),
            self._opts.timeout_ms)
        if not getattr(resp, "success", False):
            raise RpcError(Status.error(RaftError.EINTERNAL,
                                        f"describe_metrics on {endpoint}"))
        return resp.text

    async def rebalance(self, balance_group_ids: list[str],
                        conf: Configuration) -> Status:
        """Spread leaders of the given groups evenly over peers.

        Reference: ``CliServiceImpl#rebalance`` — computes the expected
        average leader count per peer and transfers leadership off
        overloaded peers.
        """
        if not balance_group_ids:
            return Status.OK()
        # voters only — learners can't lead; witnesses vote but can
        # never lead either, so they are not balancing targets
        peers = [p for p in conf.peers if not conf.is_witness(p)]
        if not peers:
            return Status.error(RaftError.EINVAL, "empty conf")
        expected = (len(balance_group_ids) + len(peers) - 1) // len(peers)
        counts: dict[str, int] = {str(p): 0 for p in peers}
        last_failure: Optional[Status] = None
        for gid in balance_group_ids:
            leader = await self.get_leader(gid, conf)
            if leader is None:
                last_failure = Status.error(RaftError.EAGAIN,
                                            f"no leader for group {gid}")
                continue
            counts.setdefault(str(leader), 0)
            counts[str(leader)] += 1
            if counts[str(leader)] > expected:
                target = min(peers, key=lambda p: counts.get(str(p), 0))
                st = await self.transfer_leader(gid, conf, target)
                if st.is_ok():
                    counts[str(leader)] -= 1
                    counts[str(target)] = counts.get(str(target), 0) + 1
                else:
                    last_failure = st
        return last_failure if last_failure is not None else Status.OK()

    # -- retry engine --------------------------------------------------------

    async def _leader_op(self, group_id: str, conf: Configuration,
                         method: str, make_req) -> Status:
        last = Status.error(RaftError.EAGAIN, "no attempt")
        attempt = 0
        busy_left = self._opts.busy_max_retry
        busy_backoff_ms = self._opts.busy_backoff_ms
        while attempt < self._opts.max_retry:
            try:
                leader = await self._require_leader(group_id, conf)
            except RpcError as e:
                last = e.status
                attempt += 1
                await asyncio.sleep(self._opts.retry_interval_ms / 1000.0)
                continue
            try:
                resp = await self._transport.call(
                    leader.endpoint, method, make_req(leader),
                    self._opts.timeout_ms)
            except RpcError as e:
                last = e.status
                attempt += 1
                self._leaders.pop(group_id, None)
                await asyncio.sleep(self._opts.retry_interval_ms / 1000.0)
                continue
            if resp.code == 0:
                return Status.OK()
            last = Status(resp.code, resp.msg)
            if resp.code == int(RaftError.EPERM):  # stale leader; refresh
                attempt += 1
                self._leaders.pop(group_id, None)
                await asyncio.sleep(self._opts.retry_interval_ms / 1000.0)
                continue
            if resp.code == int(RaftError.EBUSY):
                # another change in flight: transient by contract —
                # bounded exponential backoff, leader cache KEPT (busy
                # does not mean wrong leader)
                if busy_left <= 0:
                    return Status(
                        int(RaftError.EBUSY),
                        f"still busy after {self._opts.busy_max_retry} "
                        f"retries: {resp.msg}")
                busy_left -= 1
                await asyncio.sleep(busy_backoff_ms / 1000.0)
                busy_backoff_ms = min(busy_backoff_ms * 2,
                                      self._opts.busy_backoff_max_ms)
                continue
            return last  # definite rejection (EINVAL, ECATCHUP, ...)
        return last


def describe_status(st: Status) -> str:
    """Operator-facing classification of an admin-op status: makes
    'busy, retry later' distinguishable from 'your conf is wrong' at a
    glance (and by exit-code policy in examples/admin.py)."""
    if st.is_ok():
        return "OK"
    code = st.raft_error
    if code == RaftError.EBUSY:
        kind = "busy (transient — another membership change or a " \
               "leadership transfer is in flight; retry later)"
    elif code == RaftError.EINVAL:
        kind = "invalid request (check the configuration argument)"
    elif code == RaftError.ECATCHUP:
        kind = "new peers failed to catch up (are they running and " \
               "reachable?)"
    elif code == RaftError.EPERM:
        kind = "not leader (leadership moved; rediscover and retry)"
    elif code == RaftError.EAGAIN:
        kind = "no leader found (cluster electing or unreachable)"
    else:
        kind = "failed"
    return f"error[{code.name if code else st.code}]: {kind}: {st.error_msg}"
