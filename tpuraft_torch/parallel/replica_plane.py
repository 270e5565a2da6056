"""Replica-axis collective commit plane: a deployment mode where the
co-located replicas of MANY raft groups sit on a 2D (replica, groups)
device mesh and the quorum commit point is computed by XLA collectives
(tpuraft.parallel.collective.replicated_tick: all_gather over the
replica axis + q-th order statistic) from each replica's DURABLE
protocol state — the BASELINE.json config-4 north star ("vote-matrix
psum over ICI"), promoted from a dry-run demo to a runtime path
(VERDICT r1 #6).

Data flow per replica r of group g:
  LogManager flush fsyncs entries -> on_stable hook ->
  plane.match[r, g] = last durable index        (host -> device row)
  plane tick: commit[g] = q-th largest over the replica axis (ICI)
  leader's ReplicaBallotBox._advance(commit[g]) -> FSMCaller

Contrast with the [G, P] MultiRaftEngine plane: there, the LEADER owns a
row of acked matchIndexes that followers ECHO back over RPC; here each
replica's own durability directly feeds the reduce and no ack echo is
needed for commit advancement — the protocol plane (AppendEntries over
host RPC) still ships the entries themselves and the leader heartbeats.

SAFETY — term-scoped attestation.  A replica's raw durable tip may
include a DIVERGENT suffix from a deposed leader (raft only lets
matchIndex advance through verified AppendEntries consistency).
Counting such a row would commit entries a quorum does not actually
hold.  A row therefore counts toward leader T's quorum only while the
replica is ATTESTED to T: the replica sets accepted_term[r,g] = T
exactly when it locally knows its whole log prefix-matches T's (an
accepted append that covered its tail, or a heartbeat at its tail), and
zeroes it the moment an append from any other term touches its log.
The tick masks unattested rows to 0 before the collective reduce.
Once attested, every further durable advance IS a T-append, so the row
stays valid until the next term change.

Scope: commit advancement for symmetric R-replica groups.  Votes and
joint-consensus quorums stay on the protocol plane: a [R, G] grant
matrix cannot attribute grants to one of several concurrent candidates
(grants are per (term, candidate)), and joint consensus needs two
asymmetric voter sets — both are per-candidate/per-conf slow paths, not
the steady-state commit stream this plane accelerates.

On real hardware, each host of the mesh holds its replica's rows and
the collectives ride ICI; in one process (tests, the driver dry run) a
CPU mesh stands in, same program.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

import numpy as np

from tpuraft_torch.conf import Configuration
from tpuraft_torch.entity import PeerId

LOG = logging.getLogger(__name__)

_REBASE_LIMIT = 1 << 28


class ReplicaBallotBox:
    """BallotBox SPI over the plane: commit quorum = the collective
    reduce of durable replica rows (not echoed acks)."""

    def __init__(self, plane: "ReplicatedClusterPlane", replica: int,
                 slot: int, on_committed: Callable[[int], None]):
        self._plane = plane
        self.replica = replica
        self.slot = slot
        self._on_committed = on_committed
        self.last_committed_index = 0
        self.pending_index = 0

    # -- wiring (Node.init) --------------------------------------------------

    def attach_log_manager(self, log_manager) -> None:
        plane, r, s = self._plane, self.replica, self.slot

        def on_stable(index: int) -> None:
            # EXACT-tip semantics (not monotone max): suffix truncation
            # and InstallSnapshot resets LOWER the durable tip, and a
            # stale-high row would count dropped entries toward a quorum
            if index != plane.match[r, s]:
                plane.match[r, s] = index
                plane.mark_dirty()

        log_manager.on_stable = on_stable
        # recovered logs count as durable immediately
        on_stable(log_manager.last_log_index())

    # -- attestation (see module docstring SAFETY) ---------------------------

    def note_append_start(self, term: int) -> None:
        """An append from `term` is about to mutate this replica's log:
        if that changes leadership lineage, the old attestation dies NOW
        (before any on_stable can advance the row with foreign entries)."""
        p = self._plane
        if p.accepted_term[self.replica, self.slot] != term:
            p.accepted_term[self.replica, self.slot] = 0

    def note_attested(self, term: int) -> None:
        """This replica locally verified its whole log prefix-matches
        leader `term`'s log (append covered the tail / heartbeat at
        tail / is the leader itself)."""
        self._plane.accepted_term[self.replica, self.slot] = term
        self._plane.mark_dirty()

    # -- leader side ---------------------------------------------------------

    def reset_pending_index(self, new_pending_index: int) -> None:
        p = self._plane
        self.pending_index = new_pending_index
        p.leader_replica[self.slot] = self.replica
        p.base[self.slot] = new_pending_index - 1
        p.commit_abs[self.slot] = new_pending_index - 1
        p.mark_dirty()

    def clear_pending(self) -> None:
        self.pending_index = 0
        p = self._plane
        if p.leader_replica[self.slot] == self.replica:
            p.leader_replica[self.slot] = -1

    def commit_at(self, peer: PeerId, match_index: int, conf: Configuration,
                  old_conf: Configuration) -> bool:
        """Remote ack echoes are redundant here: the remote replica's own
        on_stable already fed its row.  Self-acks land the same way."""
        return False

    def update_conf(self, conf: Configuration, old_conf: Configuration) -> None:
        n = len(conf.peers)
        if not old_conf.is_empty() or (n and n != self._plane.R):
            raise ValueError(
                "ReplicatedClusterPlane serves symmetric R-replica groups; "
                "joint consensus / resizing needs the [G,P] engine plane "
                f"(conf={conf}, old={old_conf}, R={self._plane.R})")

    def close(self) -> None:
        self._plane.release(self)

    # -- follower side -------------------------------------------------------

    def set_last_committed_index(self, index: int) -> bool:
        if self.pending_index != 0:
            return False
        if index <= self.last_committed_index:
            return False
        self.last_committed_index = index
        self._on_committed(index)
        return True

    # plane callback
    def _advance(self, new_commit: int) -> None:
        if self.pending_index == 0:
            return
        if new_commit > self.last_committed_index:
            self.last_committed_index = new_commit
            self._on_committed(new_commit)


class ReplicatedClusterPlane:
    """One per process (or per mesh-driving host): [R, G] durable-match
    and grant planes reduced by replica-axis collectives per tick."""

    def __init__(self, n_replicas: int, max_groups: int,
                 device=None, backend: str = "torch",
                 tick_interval_ms: int = 10):
        self.R = n_replicas
        self.G = max_groups
        # backend "torch" reduces on `device` (None: the card); "numpy"
        # is the host twin, chosen explicitly
        self.device = device
        self.backend = backend
        self.tick_interval_ms = tick_interval_ms
        self.match = np.zeros((self.R, self.G), np.int64)
        self.accepted_term = np.zeros((self.R, self.G), np.int64)
        self.base = np.zeros(self.G, np.int64)
        self.commit_abs = np.zeros(self.G, np.int64)
        self.leader_replica = np.full(self.G, -1, np.int32)
        self._boxes: dict[tuple[int, int], ReplicaBallotBox] = {}
        self._slot_of: dict[str, int] = {}
        self._next_slot = 0
        self._fn = None
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self._dirty = False
        self._dirty_event = asyncio.Event()
        self.ticks = 0
        self.commit_advances = 0

    # -- registry ------------------------------------------------------------

    def slot_for(self, group_id: str) -> int:
        s = self._slot_of.get(group_id)
        if s is None:
            if self._next_slot >= self.G:
                raise RuntimeError(f"plane full: {self.G} groups")
            s = self._slot_of[group_id] = self._next_slot
            self._next_slot += 1
        return s

    def ballot_box_factory(self, group_id: str, replica: int):
        """Factory for Node(ballot_box_factory=...): one per (group,
        replica).  The replica index is this node's row."""

        def make(on_committed: Callable[[int], None]) -> ReplicaBallotBox:
            slot = self.slot_for(group_id)
            box = ReplicaBallotBox(self, replica, slot, on_committed)
            self._boxes[(replica, slot)] = box
            return box

        return make

    def release(self, box: ReplicaBallotBox) -> None:
        self._boxes.pop((box.replica, box.slot), None)
        self.match[box.replica, box.slot] = 0
        self.accepted_term[box.replica, box.slot] = 0

    def mark_dirty(self) -> None:
        self._dirty = True
        self._dirty_event.set()

    # -- tick loop -----------------------------------------------------------

    async def start(self) -> None:
        if self.backend not in ("torch", "numpy"):
            raise ValueError(f"unknown plane backend {self.backend!r} "
                             "(expected 'torch' or 'numpy')")
        if self.backend == "torch":
            from tpuraft_torch.parallel.collective import replicated_tick

            self._fn = replicated_tick(self.R, device=self.device)
            self.tick_once()  # warm the build before protocol traffic
        self._task = asyncio.ensure_future(self._loop())

    async def shutdown(self) -> None:
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        interval = self.tick_interval_ms / 1000.0
        while not self._stopped:
            if not self._dirty:
                self._dirty_event.clear()
                try:
                    await asyncio.wait_for(self._dirty_event.wait(), interval)
                except asyncio.TimeoutError:
                    continue
            self._dirty = False
            t0 = time.perf_counter()
            try:
                self.tick_once()
            except Exception:
                LOG.exception("replica plane tick failed")
                self._dirty = True
            await asyncio.sleep(
                max(0.001, (time.perf_counter() - t0) * 0.5))

    def _rebase(self) -> None:
        hot = (self.match.max(axis=0) - self.base) > _REBASE_LIMIT
        for s in np.nonzero(hot)[0]:
            self.base[s] = self.commit_abs[s]

    def tick_once(self) -> int:
        """One collective commit reduction across all groups."""
        self._rebase()
        rel = np.clip(self.match - self.base[None, :], 0, None
                      ).astype(np.int32)
        # SAFETY mask: a row only counts toward the quorum while its
        # replica is attested to the group's CURRENT leader lineage
        # (leader's own accepted_term == its current term)
        lead = self.leader_replica
        lt = np.where(
            lead >= 0,
            self.accepted_term[lead.clip(0), np.arange(self.G)], -1)
        attested = (self.accepted_term == lt[None, :]) & (lt[None, :] > 0)
        rel = np.where(attested, rel, 0)
        if self.backend == "torch":
            import torch

            if self._fn is None:
                raise RuntimeError("start() the plane before its first "
                                   "torch tick")
            # one H2D copy of rel and one launch (a groups-shard of a
            # grid each); the grant plane is a zero plane kept on the
            # device
            commit_rel, _votes = self._fn(torch.from_numpy(rel))
            if isinstance(commit_rel, torch.Tensor):  # one device
                commit_rel = (commit_rel,)
            # graftcheck: allow(host-sync) — the tick's D2H copy a groups-shard
            commit_rel = np.concatenate([c.cpu().numpy() for c in commit_rel])
        else:  # numpy oracle (no mesh): q-th largest over replicas
            q = self.R // 2 + 1
            commit_rel = np.sort(rel, axis=0)[::-1][q - 1]
        self.ticks += 1
        advanced = 0
        commit_abs = self.base + commit_rel
        for s in np.nonzero(commit_abs > self.commit_abs)[0]:
            lr = self.leader_replica[s]
            if lr < 0:
                continue
            box = self._boxes.get((int(lr), int(s)))
            if box is None or box.pending_index == 0:
                continue
            new_commit = int(commit_abs[s])
            # Raft §5.4.2: only entries of the CURRENT leadership commit
            # via quorum counting — the plane's pending baseline
            if new_commit < box.pending_index:
                continue
            self.commit_abs[s] = new_commit
            box._advance(new_commit)
            advanced += 1
        self.commit_advances += advanced
        return advanced

    def describe(self) -> str:
        return (f"ReplicatedClusterPlane<R={self.R} G={self.G} "
                f"groups={self._next_slot} backend={self.backend} "
                f"device={self.device} "
                f"ticks={self.ticks} advances={self.commit_advances}>")
