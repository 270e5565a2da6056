"""RegionEngine: one raft group member serving one region on a store.

Reference parity: ``rhea:RegionEngine`` (SURVEY.md §3.2 "StoreEngine"
row) — owns the region's raft Node (via RaftGroupService), its
KVStoreStateMachine over the store-shared RawKVStore, and the
RaftRawKVStore async API.
"""

from __future__ import annotations

import logging
from typing import Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.raft_group_service import RaftGroupService
from tpuraft_torch.entity import PeerId
from tpuraft_torch.options import NodeOptions
from tpuraft_torch.rheakv.metadata import Region, region_group_id
from tpuraft_torch.rheakv.raft_store import RaftRawKVStore
from tpuraft_torch.rheakv.raw_store import RawKVStore
from tpuraft_torch.rheakv.state_machine import KVStoreStateMachine

LOG = logging.getLogger(__name__)


class RegionEngine:
    def __init__(self, region: Region, store_engine) -> None:
        self.region = region
        self.store_engine = store_engine
        self.fsm: Optional[KVStoreStateMachine] = None
        self.raft_store: Optional[RaftRawKVStore] = None
        self._group_service: Optional[RaftGroupService] = None
        # merge barrier, leader-local half (lifecycle plane): set BEFORE
        # the seal entry is proposed so no new write is admitted after
        # the seal's position in the log is decided — the FSM's
        # replicated `sealed_into` takes over once the entry applies
        self.sealing = False

    @property
    def group_id(self) -> str:
        return region_group_id(self.store_engine.cluster_name, self.region.id)

    @property
    def node(self):
        return self._group_service.node if self._group_service else None

    def is_leader(self) -> bool:
        n = self.node
        return bool(n and n.is_leader())

    async def start(self) -> None:
        se = self.store_engine
        self.fsm = KVStoreStateMachine(
            self.region, se.raw_store, se,
            coalesce_applies=se.opts.fsm_coalesce)
        # apply worker lane (StoreEngineOptions.apply_lane): the lane
        # owns the shared raw store — the FSM routes snapshot
        # serialization through it, the raft store its fenced reads
        self.fsm.lane = se.apply_lane
        opts = se.make_node_options(self.region, self.fsm)
        self._group_service = RaftGroupService(
            self.group_id, se.server_id, opts, se.node_manager, se.transport,
            ballot_box_factory=se.ballot_box_factory())
        node = await self._group_service.start()
        if se.read_batcher is not None:
            # store-wide SAFE read amortization: this group's quorum
            # confirmations ride the store's shared beat-plane rounds
            node.read_only_service.attach_confirm_batcher(se.read_batcher)
        if se.append_batcher is not None:
            # store-wide write amortization (the read batcher's mirror):
            # this group's replicators submit their entry windows to the
            # store's windowed per-destination append rounds
            node.append_batcher = se.append_batcher
        self.raft_store = RaftRawKVStore(
            node, se.raw_store, multi_entries=se.opts.multi_op_entries,
            ack_at_commit=se.opts.ack_at_commit, lane=se.apply_lane)
        LOG.info("region engine started: %s on %s", self.region,
                 se.server_id)

    async def shutdown(self) -> None:
        if self._group_service:
            await self._group_service.shutdown()
            self._group_service = None

    async def transfer_leadership_to(self, peer: PeerId):
        return await self.node.transfer_leadership_to(peer)
