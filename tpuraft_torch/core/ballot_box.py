"""BallotBox: quorum commit tracking for one group (host runtime).

Reference parity: ``core:core/BallotBox`` + ``core:entity/Ballot``
(SURVEY.md §3.1 north-star hot path).  Reformulated: instead of one Ballot
object per pending log index, the commit point is the quorum order
statistic of the peers' matchIndex vector — the formulation proved
equivalent to per-index ballots in tests/test_ops_ballot.py and executed
batched on device by tpuraft.ops for the multi-raft engine.  During a
membership change the double-quorum (joint consensus) applies to the whole
pending window, which is conservative-safe (old conf is a subset of the
joint requirement).

This host class handles ONE group in scalar numpy/python — the
MultiRaftEngine replaces G of these with one [G, P] kernel call per tick.
"""

from __future__ import annotations

from typing import Callable, Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.entity import PeerId
from tpuraft_torch.errors import Status


def commit_point(match: dict[PeerId, int], conf: Configuration,
                 old_conf: Configuration) -> int:
    """Scalar mirror of ops.ballot.joint_quorum_match_index PLUS the
    witness data-clamp — the device kernel carries the same clamp
    (ops.ballot.witness_commit_clamp), and the two are differentially
    enumerated against each other in test_ops_tick.

    Witness-aware: witnesses are ordinary voters in the order statistic
    (they ack metadata appends), but the commit point is additionally
    CLAMPED to the best DATA replica's match — an index no data voter
    has stored must never commit, however many witness acks it holds.
    A "data replica" is a voter that is a witness in NEITHER config:
    the replication plane strips payloads for a peer flagged witness in
    either conf (Node#peer_is_witness), so a data-in-old voter being
    demoted to witness holds no payload for joint-window entries and
    must not anchor the clamp.  Normally a no-op (the leader is always
    a data replica and its own match row covers the tail), so this is
    defense in depth against a witness-only quorum certifying
    payload-free commits (the ISSUE's witness-majority-must-not-commit
    case, enumerated in tests/test_witness.py against util/quorum.py)."""

    def order_stat(peers: list[PeerId]) -> int:
        vals = sorted((match.get(p, 0) for p in peers), reverse=True)
        if not vals:
            return -1
        return vals[len(peers) // 2]  # q-th largest, q = n//2+1

    new_q = order_stat(conf.peers)
    if not old_conf.is_empty():
        new_q = min(new_q, order_stat(old_conf.peers))
    if conf.witnesses or old_conf.witnesses:
        wits = set(conf.witnesses) | set(old_conf.witnesses)
        data = (set(conf.peers) | set(old_conf.peers)) - wits
        data_best = max((match.get(p, 0) for p in data), default=0)
        new_q = min(new_q, data_best)
    return new_q


# graftcheck: loop-confined — commit_at/update_conf run on the node's
# event loop; the engine-backed TpuBallotBox keeps the same contract
class BallotBox:
    def __init__(self, on_committed: Callable[[int], None]):
        self._on_committed = on_committed  # FSMCaller#onCommitted
        self.last_committed_index = 0
        self.pending_index = 0  # first index of current leadership; 0 = not leader
        self._match: dict[PeerId, int] = {}

    # -- leader side ---------------------------------------------------------

    def reset_pending_index(self, new_pending_index: int) -> None:
        """At becomeLeader: only entries from here on may be quorum-committed
        (Raft §5.4.2 — reference: BallotBox#resetPendingIndex)."""
        self.pending_index = new_pending_index
        self._match.clear()

    def clear_pending(self) -> None:
        self.pending_index = 0
        self._match.clear()

    def commit_at(self, peer: PeerId, match_index: int, conf: Configuration,
                  old_conf: Configuration) -> bool:
        """Record peer's acked matchIndex; advance commit if quorum reached.
        Returns True if the commit index advanced."""
        if self.pending_index == 0:
            return False
        prev = self._match.get(peer, 0)
        if match_index <= prev:
            return False
        self._match[peer] = match_index
        point = commit_point(self._match, conf, old_conf)
        if point < self.pending_index or point <= self.last_committed_index:
            return False
        self.last_committed_index = point
        self._on_committed(point)
        return True

    def update_conf(self, conf: Configuration, old_conf: Configuration) -> None:
        """Membership changed: drop match rows for peers no longer in any
        voter/learner set.  Load-bearing for churn: a voter that is
        removed, wiped, and later re-added must re-earn its matchIndex
        from zero — its stale pre-removal row counting toward the quorum
        order statistic would commit entries the reborn peer never
        stored, breaking quorum intersection.  (The engine-backed
        TpuBallotBox maintains device voter masks in its override.)"""
        members = set(conf.peers) | set(old_conf.peers) \
            | set(conf.learners) | set(old_conf.learners)
        for peer in [p for p in self._match if p not in members]:
            del self._match[peer]

    def close(self) -> None:
        """SPI hook: release engine resources (no-op for the scalar box)."""

    # -- follower side -------------------------------------------------------

    def set_last_committed_index(self, index: int) -> bool:
        """Follower: leader said commit has reached ``index``."""
        if self.pending_index != 0:
            return False  # leaders ignore remote commit notices
        if index <= self.last_committed_index:
            return False
        self.last_committed_index = index
        self._on_committed(index)
        return True
