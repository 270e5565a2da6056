"""MultiRaftEngine: one device tick advances ALL raft groups in a process.

The north-star component (BASELINE.json): the per-group consensus
bookkeeping becomes rows of ``[G, P]`` tensors and ONE
``raft_tick`` (tpuraft_torch.ops.tick) per engine tick computes every group's
commit advancement, election-timeout firing, vote quorums, leader-lease
validity / dead-quorum step-down, and heartbeat scheduling on device —
the full SURVEY §8.1 device plane, not just the commit reduce.

Wiring: host Nodes get their ballot boxes from :meth:`ballot_box_factory`
(the analog of plugging TpuBallotBox through the reference's
``JRaftServiceLoader`` SPI).  With ``TickOptions.drive_protocol`` (the
default), the box also hands the node an :class:`EngineControl` — the
device-plane replacement for the reference's per-group RepeatedTimers
(``electionTimer``/``voteTimer``/``stepDownTimer``), the ``_peer_acks``
map behind ``NodeImpl#checkDeadNodes``, and the per-round vote tally of
``NodeImpl#handleRequestVoteResponse``.  The engine's numpy mirrors are
then the single source of truth for deadlines / acks / votes; the tick's
output masks schedule the slow-path protocol handlers, which re-verify
under the node lock (the host stays the single writer of protocol state,
mirroring NodeImpl's writeLock discipline).

Division of labor per event:
  election_due  -> Node._on_election_due (pre-vote / vote-timeout retry)
  elected       -> Node._on_engine_elected (becomeLeader)
  step_down     -> Node._on_engine_quorum_dead (checkDeadNodes)
  hb_due        -> batched empty-AppendEntries via HeartbeatHub.pulse
  commit        -> TpuBallotBox._advance -> FSMCaller.on_committed

The tick loop is ADAPTIVE: a dirty mark (new ack / vote / deadline
change) fires a tick immediately — commit acks are not quantized to a
fixed cadence — while consecutive ticks self-pace by the previous tick's
cost (slow tunneled devices batch more per dispatch).  Idle engines
sleep until the next election/heartbeat deadline, capped at
``tick_interval_ms``.

Index-domain note: the device works in int32 *relative* indexes
(``abs - base[g]``); the engine re-bases a group whenever its relative
window approaches 2^28, so unbounded absolute indexes never overflow.
Times are int32 ms since engine start, epoch-shifted before they near
2^30 (multi-week uptimes never overflow).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Callable, Optional

import numpy as np

from tpuraft_torch.conf import Configuration
from tpuraft_torch.entity import PeerId
from tpuraft_torch.options import TickOptions
from tpuraft_torch.util import clock as clockmod
from tpuraft_torch.util.trace import RECORDER as _RECORDER
from tpuraft_torch.ops.tick import (
    ROLE_CANDIDATE,
    ROLE_FOLLOWER,
    ROLE_INACTIVE,
    ROLE_LEADER,
)

LOG = logging.getLogger(__name__)

_REBASE_LIMIT = 1 << 28
_TIME_REBASE_MS = 1 << 30        # epoch-shift threshold (int32 headroom)
_NEG_I32 = -(2 ** 30)            # matches tpuraft.ops.ballot.NEG_INF_I32
# protocol-param defaults for slots no node has registered yet
_DEF_ETO_MS, _DEF_HB_MS, _DEF_LEASE_MS = 1000, 100, 900


class TpuBallotBox:
    """Drop-in for core.ballot_box.BallotBox backed by the engine tensors.

    Mutations write numpy mirrors and mark the engine dirty; quorum math
    happens on device at the next engine tick.
    """

    def __init__(self, engine: "MultiRaftEngine", slot: int,
                 on_committed: Callable[[int], None]):
        self._engine = engine
        self.slot = slot
        self._on_committed = on_committed
        self.last_committed_index = 0
        self.pending_index = 0

    # -- control-plane seam --------------------------------------------------

    def make_control(self, node) -> Optional["EngineControl"]:
        """Hand the node the engine's device control plane (or None to
        keep host timers, when drive_protocol is off)."""
        if not self._engine.opts.drive_protocol:
            return None
        return EngineControl(self._engine, node, self)

    # -- leader side ---------------------------------------------------------

    def reset_pending_index(self, new_pending_index: int) -> None:
        e = self._engine
        self.pending_index = new_pending_index
        e.base[self.slot] = new_pending_index - 1
        e.pending_rel[self.slot] = 1
        e.match_abs[self.slot, :] = 0
        # commit baseline for the device gate `q > commit_now`: nothing of
        # THIS leadership is committed yet (slot may be reused from a
        # prior node)
        e.commit_abs[self.slot] = new_pending_index - 1
        e.role[self.slot] = ROLE_LEADER
        e.mark_dirty()

    def clear_pending(self) -> None:
        self.pending_index = 0
        e = self._engine
        # a controlled slot stays an engine-scheduled follower; a bare
        # box (commit plane only) goes inactive
        e.role[self.slot] = (
            ROLE_FOLLOWER if e.has_ctrl[self.slot] else ROLE_INACTIVE)
        e.match_abs[self.slot, :] = 0

    def commit_at(self, peer: PeerId, match_index: int, conf: Configuration,
                  old_conf: Configuration) -> bool:
        """Record the ack.  With ``TickOptions.eager_commit`` (default)
        the ack that completes a quorum advances the commit point RIGHT
        HERE — one scalar order statistic over this slot's [P] row, the
        same joint math the device tick reduces — instead of waiting
        out the tick pace.  The tick remains the batch plane (and the
        safety net: it recomputes the same value); a hot group's
        quorum closes on the ack path, event-driven, exactly like the
        scalar BallotBox."""
        if self.pending_index == 0:
            return False
        e = self._engine
        col = e.peer_col(self.slot, peer)
        if col is None:
            return False
        if match_index > e.match_abs[self.slot, col]:
            e.match_abs[self.slot, col] = match_index
            if e.opts.eager_commit:
                # the ack path IS the commit tally now — no dirty mark:
                # a per-ack tick would re-reduce all [G] rows just to
                # find the commit this call already advanced (measured:
                # ack-driven ticks were ~2/3 of the loop's CPU at 1024
                # regions under write load).  Deadline-driven work
                # (beats, elections, snapshots) wakes the tick loop on
                # its own clock, and set_conf/role transitions keep
                # their explicit mark_dirty — a conf shrink that
                # advances the quorum without a new ack still gets its
                # discovery tick from set_conf's own mark.
                return e.eager_commit_slot(self.slot)
            e.mark_dirty()
        return False

    def update_conf(self, conf: Configuration, old_conf: Configuration) -> None:
        self._engine.set_conf(self.slot, conf, old_conf)

    def close(self) -> None:
        self._engine.release(self)

    # -- follower side -------------------------------------------------------

    def set_last_committed_index(self, index: int) -> bool:
        if self.pending_index != 0:
            return False
        if index <= self.last_committed_index:
            return False
        self.last_committed_index = index
        self._on_committed(index)
        return True

    # engine callback
    def _advance(self, new_commit: int) -> None:
        if self.pending_index == 0:
            return
        if new_commit > self.last_committed_index:
            self.last_committed_index = new_commit
            self._on_committed(new_commit)


class EngineControl:
    """Per-node handle to the engine's device control plane.

    Replaces, for engine-backed nodes, the reference's per-group timers
    and scalar tallies (SURVEY §3.1 "Timers & queues", §4.3):

      electionTimer/voteTimer  -> elect_deadline[g] + election_due mask
      vote tally (_VoteCtx)    -> granted[g,:] + elected mask
      stepDownTimer/_peer_acks -> last_ack[g,:] + step_down/lease masks
      heartbeat timers/hub tick-> hb_deadline[g] + hb_due mask

    Pre-vote tallies stay host-side scalars by design: the device role
    encoding has no pre-vote state (tpuraft.ops.tick) — pre-vote is a
    rare, transient probe that never mutates durable terms.

    One-off scalar queries (lease_valid for a single read, dead-quorum
    re-verification under the node lock) compute host-side from the SAME
    engine rows the device reduces — one [P] row, not a second copy of
    the state.
    """

    drives_heartbeats = True
    drives_snapshots = True
    # the device tick tallies SAFE ReadIndex rounds (fence_ok lane):
    # ReadConfirmBatcher checks this to skip its host-side per-ack set
    drives_read_fences = True

    def __init__(self, engine: "MultiRaftEngine", node, box: TpuBallotBox):
        self.engine = engine
        self.node = node
        self.slot = box.slot
        opts = node.options
        self._eto_ms = opts.election_timeout_ms
        # the lease is per-NODE (eto x ratio): the engine-wide lease_ms
        # param only feeds the device lease_valid mask, and a node whose
        # eto is shorter than the engine's must not inherit a lease
        # longer than its own election timeout (stale LEASE_BASED reads).
        # The (1 - rho) factor is the clock-drift safety margin (ISSUE
        # 18): the quorum granted us eto*ratio on THEIR clocks; ours may
        # run up to rho fast, so we only trust that fraction of it.
        self._lease_ms = int(self._eto_ms
                             * opts.raft_options.leader_lease_time_ratio
                             * (1.0 - opts.raft_options.clock_drift_bound))
        self._jitter_range = max(1, min(opts.raft_options.max_election_delay_ms,
                                        self._eto_ms))
        self._jitter = random.randrange(self._jitter_range)
        self._scheduled: set = set()
        # quiescence ("hibernate raft") state
        self._quiesce_after = opts.raft_options.quiesce_after_rounds
        self._quiesce_streak = 0
        self._quiesce_await: Optional[set] = None   # peers yet to ack
        self._lease_eps: list[str] = []   # leader: endpoints on the lease
        self._lease_src: Optional[str] = None  # follower: leader's store
        snap_ms = 0
        if opts.snapshot_uri and opts.snapshot.interval_secs > 0:
            snap_ms = opts.snapshot.interval_secs * 1000
        eff = engine.register_ctrl(
            self, node.server_id,
            eto_ms=self._eto_ms,
            hb_ms=max(1, self._eto_ms
                      // opts.raft_options.election_heartbeat_factor),
            lease_ms=int(self._eto_ms
                         * opts.raft_options.leader_lease_time_ratio
                         * (1.0 - opts.raft_options.clock_drift_bound)),
            snapshot_ms=snap_ms)
        if eff != self._eto_ms:
            self._adopt_eto(eff)

    def _adopt_eto(self, eff_eto_ms: int) -> None:
        """The engine's density floor raised this group's effective
        election timeout: adopt it host-side too, so RPC budgets, the
        follower leader-contact lease and jitter all agree with the
        device rows (a host lease shorter than the device timeout would
        re-open the vote guards long before any deadline can fire)."""
        opts = self.node.options
        if eff_eto_ms != opts.election_timeout_ms:
            LOG.info("%s: density floor raised election timeout "
                     "%dms -> %dms", self.node,
                     opts.election_timeout_ms, eff_eto_ms)
            opts.election_timeout_ms = eff_eto_ms
        self._eto_ms = eff_eto_ms
        self._lease_ms = int(eff_eto_ms
                             * opts.raft_options.leader_lease_time_ratio)
        self._jitter_range = max(1, min(
            opts.raft_options.max_election_delay_ms, eff_eto_ms))
        self._jitter = min(self._jitter, self._jitter_range - 1)

    # -- scheduling plumbing (engine tick -> node slow path) -----------------

    def schedule(self, name: str, handler) -> None:
        """Fire-and-dedupe: at most one outstanding handler per event
        kind — the tick may re-emit a mask for several ticks before the
        async handler flips the role."""
        if name in self._scheduled:
            return
        self._scheduled.add(name)

        async def run():
            try:
                await handler()
            except Exception:  # noqa: BLE001 — one group's handler only
                LOG.exception("engine event %s for %s failed",
                              name, self.node)
            finally:
                self._scheduled.discard(name)

        asyncio.ensure_future(run())

    def push_election_deadline(self, now_ms: Optional[int] = None,
                               new_jitter: bool = True) -> None:
        if now_ms is None:
            now_ms = self.engine.now_ms()
        if new_jitter:
            self._jitter = random.randrange(self._jitter_range)
        self.engine.elect_deadline[self.slot] = (
            now_ms + self._eto_ms + self._jitter)

    # -- node-facing API (mirrors TimerControl in tpuraft.core.node) ---------

    def start_follower(self) -> None:
        e = self.engine
        self._clear_quiesce_state()
        e.role[self.slot] = ROLE_FOLLOWER
        self.push_election_deadline()
        e.mark_dirty()

    def note_leader_contact(self) -> None:
        """Hot path (every AppendEntries): push the election deadline.
        Reuses the cached jitter — no RNG per append."""
        self.engine.elect_deadline[self.slot] = (
            self.engine.now_ms() + self._eto_ms + self._jitter)

    def on_candidate(self) -> None:
        e = self.engine
        self._clear_quiesce_state()
        e.role[self.slot] = ROLE_CANDIDATE
        self.push_election_deadline()   # vote-round timeout
        e.mark_dirty()

    def stop_vote_wait(self) -> None:
        pass  # deadline is inert once the role leaves CANDIDATE

    def start_vote_round(self) -> bool:
        """Clear the vote row, grant self.  Returns True when self alone
        is a quorum (single-voter group) — the engine's elected mask
        handles the multi-voter async case."""
        e = self.engine
        e.granted[self.slot, :] = False
        col = e.peer_col(self.slot, self.node.server_id)
        if col is not None:
            e.granted[self.slot, col] = True
        e.mark_dirty()
        return self.vote_quorum_now()

    def grant_vote(self, peer: PeerId) -> bool:
        """Record a granted vote.  Always returns False: the tally is the
        device tick's elected mask (-> Node._on_engine_elected)."""
        e = self.engine
        col = e.peer_col(self.slot, peer)
        if col is not None:
            e.granted[self.slot, col] = True
            e.mark_dirty()
        return False

    def vote_quorum_now(self) -> bool:
        """Host-side row check of the SAME granted/voter rows the device
        reduces — used to confirm `elected` under the node lock."""
        e, s = self.engine, self.slot
        g, vm, ovm = e.granted[s], e.voter_mask[s], e.old_voter_mask[s]

        def ok(mask):
            n = int(mask.sum())
            return n > 0 and int((g & mask).sum()) >= n // 2 + 1

        return ok(vm) and (not ovm.any() or ok(ovm))

    def on_leader(self) -> None:
        e, s = self.engine, self.slot
        now = e.now_ms()
        self._clear_quiesce_state()
        e.role[s] = ROLE_LEADER
        # grace period (reference: becomeLeader resets the replicators'
        # lastRpcSendTimestamp): every peer counts as freshly acked, so
        # dead-quorum step-down fires one full election timeout later,
        # not instantly on a fresh leader with silent followers
        e.last_ack[s, :] = now
        e.hb_deadline[s] = now       # beat on the next tick
        # periodic stepdown/priority cadence (the reference's
        # stepDownTimer at eto/2): first check one half-timeout out
        e.stepdown_deadline[s] = now + max(1, self._eto_ms // 2)
        e.granted[s, :] = False
        e.mark_dirty()

    def on_step_down(self, was_candidate: bool, was_leader: bool) -> None:
        self._clear_quiesce_state()
        self.engine.granted[self.slot, :] = False

    def on_follower(self) -> None:
        self.start_follower()

    # -- ack bookkeeping (replaces Node._peer_acks) --------------------------

    def record_ack(self, peer: PeerId, when: float) -> None:
        e = self.engine
        col = e.peer_col(self.slot, peer)
        if col is not None:
            ms = e.to_ms(when)
            if ms > e.last_ack[self.slot, col]:
                e.last_ack[self.slot, col] = ms
                # acks deliberately don't wake the tick (eager_commit
                # note in TpuBallotBox.commit_at) — EXCEPT while a read
                # fence is pending: its resolution IS this tick's q_ack
                # reduction, so the ack that completes the fence quorum
                # must drive a tick instead of waiting out a deadline
                if e.fence_start[self.slot] > _NEG_I32:
                    e.mark_dirty()

    # -- device read-fence plane (ReadConfirmBatcher rounds) -----------------

    def arm_read_fence(self, fence) -> None:
        """Register a pending SAFE ReadIndex round: the device tick's
        fence_ok lane calls ``fence.note_quorum()`` once the fused q_ack
        reduction reaches the round's start time.  ``fence`` needs
        ``note_quorum()`` and a ``done`` property (store_engine's
        _GroupFence); round-timeout cleanup stays with the caller."""
        self.engine.arm_read_fence(self.slot, fence)

    def _quorum_ack_ms(self) -> int:
        """q-th newest voter ack (joint-consensus aware), host-side from
        the engine row.  Counts self as acked now."""
        e, s = self.engine, self.slot
        now = e.now_ms()
        col = e.peer_col(s, self.node.server_id)
        row = e.last_ack[s].copy()
        if col is not None:
            row[col] = now

        def q_ack(mask):
            vals = np.sort(row[mask])[::-1]
            n = vals.size
            return int(vals[n // 2]) if n else _NEG_I32

        q = q_ack(e.voter_mask[s])
        if e.old_voter_mask[s].any():
            q = min(q, q_ack(e.old_voter_mask[s]))
        return q

    def quorum_ack_age_s(self) -> float:
        q = self._quorum_ack_ms()
        if q <= _NEG_I32:
            return float("inf")
        return max(0.0, (self.engine.now_ms() - q) / 1000.0)

    def lease_valid(self) -> bool:
        # a suspect local clock invalidates every timing argument the
        # lease rests on: fail closed (reads fall back to SAFE quorum
        # confirmation, which is clock-independent) — ISSUE 18
        sentinel = self.node.options.clock_sentinel
        if sentinel is not None and not sentinel.lease_check():
            return False
        e = self.engine
        # device lane fast path: the last tick's fused q_ack reduction
        # (ops/tick.py lease_valid lane) is a LOWER bound on the current
        # quorum-ack time — acks only ever arrive — so a lease check
        # that passes against it is sound without copying+sorting the
        # [P] row per read.  A miss (stale row, ack between ticks, or
        # genuinely expired) falls back to the exact host-side check.
        q = int(e.tick_q_ack[self.slot])
        if q > _NEG_I32 and e.now_ms() - q < self._lease_ms:
            e.lease_lane_hits += 1
            return True
        e.lease_lane_misses += 1
        if (e.now_ms() - self._quorum_ack_ms()
                < self._lease_ms):
            return True
        # quiescent leader: its per-group ack stream is suppressed, so
        # the store-level lease IS the leader lease (LEASE_BASED reads /
        # dead-quorum re-verification consult it through here).  The
        # rows are normally refreshed by note_store_ack, but an ack
        # landing between ticks must not fail a read spuriously.
        return self.is_quiescent() and self.store_lease_quorum_ok()

    def alive_peers(self) -> list[PeerId]:
        e, s = self.engine, self.slot
        horizon = e.now_ms() - self._eto_ms
        out = []
        for peer in self.node.list_peers():
            if peer == self.node.server_id:
                out.append(peer)
                continue
            col = e.peer_col(s, peer)
            if col is not None and e.last_ack[s, col] > horizon:
                out.append(peer)
        return out

    # -- quiescence ("hibernate raft") ---------------------------------------
    # A fully-replicated idle leader group hibernates after N consecutive
    # fully-acked beat rounds: the device masks skip it (hb_due /
    # election_due), its followers suppress election timeouts, and
    # liveness is delegated to ONE store-level lease beat per endpoint
    # pair (HeartbeatHub) — idle beat traffic collapses from O(G x P)
    # rows to O(stores^2) RPCs.  Any apply / conf change / vote request /
    # incoming entries instantly wakes the group; a store-lease expiry
    # wakes its dependents with randomized election timeouts.

    def is_quiescent(self) -> bool:
        return bool(self.engine.quiescent[self.slot])

    def note_activity(self) -> None:
        """Hot-path hook on protocol activity (apply staged, vote
        request, entries received): one array read when awake."""
        if self.engine.quiescent[self.slot]:
            self.wake_from_quiescence("activity")

    def _hub(self):
        nm = self.node.node_manager
        return None if nm is None else nm.heartbeat_hub

    def maybe_quiesce(self, now: int) -> None:
        """Called by the engine on every hb_due round for this (awake,
        leader) slot: track the idle streak; at the threshold this
        round's beats carry the quiesce handshake (hub.pulse reads the
        per-replicator intent), and the group hibernates only once
        EVERY follower acked — a refusal keeps it active, because a
        follower with a live election timer must keep receiving beats."""
        if self._quiesce_after <= 0 or self.engine.quiescent[self.slot]:
            return
        if not self._quiesce_eligible(now):
            self._quiesce_streak = 0
            self._quiesce_await = None
            return
        self._quiesce_streak += 1
        if self._quiesce_streak < self._quiesce_after:
            return
        reps = self.node.replicators.all()
        if not reps:
            # single-voter group: nobody to hand-shake, no lease needed
            # (its own self-ack keeps step_down quiet) — hibernate now
            self._finalize_quiesce()
            return
        self._quiesce_await = {r.peer for r in reps}
        for r in reps:
            r._quiesce_lease_ms = self._eto_ms

    def _quiesce_eligible(self, now: int) -> bool:
        """No pending appends, full match at the tail, not mid-change,
        every voter freshly acked — the 'provably idle' predicate."""
        node = self.node
        if node.node_manager is None or node.state.name != "LEADER":
            return False
        if node._conf_ctx is not None:
            return False
        e, s = self.engine, self.slot
        if e.old_voter_mask[s].any():
            return False
        tail = node.log_manager.last_log_index()
        if node.ballot_box.last_committed_index != tail:
            return False
        reps = node.replicators.all()
        for r in reps:
            if (not r._matched or r.retiring or r.match_index < tail
                    or not r.peer_multi_hb):
                return False
        if reps:
            # every voter acked within the last two beat intervals
            horizon = now - 2 * int(e.hb_ms[s]) - 50
            row, mask = e.last_ack[s], e.voter_mask[s].copy()
            col = int(e.self_col[s])
            if 0 <= col < mask.size:
                mask[col] = False
            if mask.any() and bool((row[mask] < horizon).any()):
                return False
        return True

    def note_quiesce_ack(self, peer: PeerId) -> None:
        """A follower acked a quiesce-handshake beat."""
        aw = self._quiesce_await
        if aw is None:
            return
        aw.discard(peer)
        if not aw:
            self._quiesce_await = None
            self._finalize_quiesce()

    def abort_quiesce(self) -> None:
        """A follower refused (or the fast path fell back): stay active."""
        self._quiesce_await = None
        self._quiesce_streak = 0

    def _finalize_quiesce(self) -> None:
        e, s = self.engine, self.slot
        node = self.node
        if e.quiescent[s] or node.node_manager is None:
            return
        if not self._quiesce_eligible(e.now_ms()):
            # an apply raced the handshake acks: stay active
            self._quiesce_streak = 0
            return
        e.quiescent[s] = True
        e.quiesce_events += 1
        # coalesced: a hibernation sweep at region density flips
        # thousands of groups at once — per-group rows would evict the
        # whole ring (the steady trickle keeps its per-group detail)
        _RECORDER.record_coalesced("quiesce", node.group_id,
                                   per_group=False,
                                   node=str(node.server_id),
                                   role="leader")
        hub = node.node_manager.heartbeat_hub
        hub.groups_quiesced += 1
        eps = sorted({r.peer.endpoint for r in node.replicators.all()})
        self._lease_eps = eps
        src = node.server_id.endpoint
        for ep in eps:
            hub.lease_add(ep, e, node.transport, src, self._eto_ms)
        e.note_quiesce_leader(s)

    def enter_quiescent_follower(self, leader_endpoint: str,
                                 lease_ms: int) -> bool:
        """The leader proposed hibernation via a quiesce beat and this
        node matched its row at the tail: suppress the election timeout
        and ride the leader store's liveness lease instead."""
        node = self.node
        e, s = self.engine, self.slot
        if node.node_manager is None:
            return False
        if e.quiescent[s]:
            return True
        e.quiescent[s] = True
        e.quiesce_events += 1
        _RECORDER.record_coalesced("quiesce", node.group_id,
                                   per_group=False,
                                   node=str(node.server_id),
                                   role="follower", src=leader_endpoint)
        self._lease_src = leader_endpoint
        hub = node.node_manager.heartbeat_hub
        hub.groups_quiesced += 1
        hub.lease_depend(leader_endpoint, self, lease_ms or self._eto_ms)
        return True

    def wake_from_quiescence(self, reason: str = "activity",
                             lease_expired: bool = False) -> None:
        e, s = self.engine, self.slot
        if not e.quiescent[s]:
            return
        _RECORDER.record_coalesced("wake", self.node.group_id,
                                   per_group=False,
                                   node=str(self.node.server_id),
                                   reason=reason)
        now = e.now_ms()
        # a follower waking under a FRESH store lease (e.g. a vote
        # solicitation from a restarted peer) must carry the delegated
        # liveness proof back into the per-group guard: clearing the
        # quiescent state kills quiescent_leader_alive(), and the raw
        # _last_leader_timestamp went stale by design while hibernating
        # — without this refresh the vote guards would swing open the
        # moment a group wakes, letting one restarted store depose
        # every healthy hibernating leader it pre-votes against
        leader_alive = self.quiescent_leader_alive()
        self._clear_quiesce_state()
        if leader_alive:
            self.node._last_leader_timestamp = self.node._clock.monotonic()
        if e.role[s] == ROLE_LEADER:
            e.hb_deadline[s] = now   # beat NOW; followers wake on it
        else:
            self._jitter = random.randrange(self._jitter_range)
            # store-lease expiry wakes WHOLE stores' worth of groups at
            # once: spread their elections over an extra full timeout so
            # the herd stays under the host's election capacity
            extra = random.randrange(self._eto_ms) if lease_expired else 0
            e.elect_deadline[s] = now + self._eto_ms + self._jitter + extra
        e.mark_dirty()

    def wake_for_lease_expiry(self) -> None:
        """Hub lease watcher: the store this group's (quiescent) leader
        lives on went silent past its lease — resume fault detection."""
        self.wake_from_quiescence("store-lease-expiry", lease_expired=True)

    def _clear_quiesce_state(self) -> None:
        e, s = self.engine, self.slot
        was = bool(e.quiescent[s])
        e.quiescent[s] = False
        self._quiesce_streak = 0
        self._quiesce_await = None
        hub = self._hub()
        if self._lease_eps:
            e.note_wake_leader(s)
            if hub is not None:
                for ep in self._lease_eps:
                    hub.lease_remove(ep, e)
            self._lease_eps = []
        if self._lease_src is not None:
            if hub is not None:
                hub.lease_undepend(self._lease_src, self)
            self._lease_src = None
        if was:
            e.wake_events += 1
            if hub is not None:
                hub.groups_woken += 1

    def quiescent_leader_alive(self) -> bool:
        """Follower-side vote-guard consult: while hibernating, 'my
        leader is alive' means 'its store's lease is fresh' — the
        per-group leader-contact timestamp legitimately goes stale."""
        e, s = self.engine, self.slot
        if not e.quiescent[s] or self._lease_src is None:
            return False
        hub = self._hub()
        return hub is not None and hub.lease_fresh(self._lease_src)

    def store_lease_quorum_ok(self) -> bool:
        """Leader-side lease-read consult for a QUIESCENT group: fresh
        store-lease acks must cover a voter quorum (the per-group ack
        stream is suppressed, so the store lease IS the leader lease)."""
        node = self.node
        hub = self._hub()
        if hub is None:
            return False
        voters = node.list_peers()
        if not voters:
            return False
        ok = sum(1 for p in voters
                 if p == node.server_id
                 or hub.lease_ack_fresh(p.endpoint, self._lease_ms))
        return ok >= len(voters) // 2 + 1

    # -- lifecycle -----------------------------------------------------------

    def deactivate(self) -> None:
        self._clear_quiesce_state()
        self.engine.role[self.slot] = ROLE_INACTIVE

    def shutdown(self) -> None:
        self.deactivate()
        self.engine.unregister_ctrl(self.slot)


class _NpOutputs:
    """numpy TickOutputs twin (the backend="numpy" tick's result, and the
    host-side unpacking of a torch tick's outputs)."""

    __slots__ = ("commit_rel", "commit_advanced", "elected", "election_due",
                 "step_down", "hb_due", "lease_valid", "snap_due", "q_ack",
                 "stepdown_due", "fence_ok")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


# Mirror fields staged per tick, in GroupState order: int32 planes first
# (4-byte aligned views), then the bool planes (at any byte offset).
_I32_FIELDS = (("role", 1), ("commit_rel", 1), ("pending_rel", 1),
               ("match_rel", 2), ("elect_deadline", 1), ("hb_deadline", 1),
               ("last_ack", 2), ("snap_deadline", 1),
               ("stepdown_deadline", 1), ("fence_start", 1))
_BOOL_FIELDS = (("granted", 2), ("voter_mask", 2), ("old_voter_mask", 2),
                ("quiescent", 1), ("witness_mask", 2))


class _TickStaging:
    """Host<->device staging for one shard of an engine's torch tick
    (the whole engine on one device is one shard): one byte buffer holds
    every GroupState field of the shard's rows (pinned on the host when
    the tick runs on CUDA), mirrored by one device buffer whose typed
    views are the tick's inputs; the tick writes its packed outputs into
    one more device buffer, which comes back in one copy."""

    def __init__(self, g: int, p: int, device, rows: slice = slice(None)):
        import torch

        from tpuraft_torch.ops.tick import packed_nbytes
        from tpuraft_torch.parallel.mesh import pinned_staging

        self.g, self.device, self.rows = g, device, rows
        cuda = device.type == "cuda"
        # the tick's inputs: typed views of the device buffer, made once
        self.host, self.dev, self.host_views, self.dev_views = \
            pinned_staging([(name, dtype, (g, p) if rank == 2 else (g,))
                            for dtype, specs in ((torch.int32, _I32_FIELDS),
                                                 (torch.bool, _BOOL_FIELDS))
                            for name, rank in specs], device)
        self.out_dev = torch.empty(packed_nbytes(g), dtype=torch.uint8,
                                   device=device)
        self.out_host = (torch.empty(packed_nbytes(g), dtype=torch.uint8,
                                     pin_memory=True)
                         if cuda else self.out_dev)

    def fill(self, e: "MultiRaftEngine", rel, commit_rel_now) -> None:
        """Write this tick's mirrors of the shard's rows into the host
        buffer (int64 time rows wrap to int32 exactly like
        ``astype(np.int32)``)."""
        v, r = self.host_views, self.rows
        for name, src in (("role", e.role), ("commit_rel", commit_rel_now),
                          ("pending_rel", e.pending_rel), ("match_rel", rel),
                          ("elect_deadline", e.elect_deadline),
                          ("hb_deadline", e.hb_deadline),
                          ("last_ack", e.last_ack),
                          ("snap_deadline", e.snap_deadline),
                          ("stepdown_deadline", e.stepdown_deadline),
                          ("fence_start", e.fence_start),
                          ("granted", e.granted),
                          ("voter_mask", e.voter_mask),
                          ("old_voter_mask", e.old_voter_mask),
                          ("quiescent", e.quiescent),
                          ("witness_mask", e.witness_mask)):
            np.copyto(v[name], src[r], casting="unsafe")

    def upload(self) -> dict:
        """One host->device copy; returns the typed device views."""
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)
        return self.dev_views

    def fetch(self) -> None:
        """Start the one copy of the packed outputs (``out_dev``,
        written by the tick) to the host; :meth:`landed` reads them once
        the shard's stream is synchronized."""
        if self.out_host is not self.out_dev:
            self.out_host.copy_(self.out_dev, non_blocking=True)

    def landed(self) -> dict:
        """The packed outputs as numpy rows (copied out of the reused
        buffer, so a caller may keep them)."""
        from tpuraft_torch.ops.tick import unpack_outputs_numpy

        # graftcheck: allow(host-sync) — the tick's one D2H copy, landed
        host = self.out_host.numpy().copy()
        return unpack_outputs_numpy(host, self.g)


class MultiRaftEngine:
    """Per-process batched consensus plane.  Start once, register each
    node's ballot box through :meth:`ballot_box_factory`."""

    def __init__(self, opts: Optional[TickOptions] = None):
        self.opts = opts or TickOptions()
        g, p = self.opts.max_groups, self.opts.max_peers
        self.G, self.P = g, p
        # numpy mirrors (host-owned truth between ticks) — commit plane.
        # Every [G]-leading row below is a LANE under graftcheck's
        # lane-coverage rule: it must be handled at _grow (pad), release
        # (slot reset), set_conf (conf re-map/invalidation) and
        # _maybe_time_rebase (time epoch shift), or carry a reasoned
        # `# lane: no-<site>` waiver here on its declaration.
        # lane: no-shift — log-index domain (rebased by _rebase, not the
        # time epoch)
        self.match_abs = np.zeros((g, p), np.int64)
        # lane: no-conf no-shift — per-group log base, conf-independent
        self.base = np.zeros(g, np.int64)
        # lane: no-conf no-shift — leadership window, reset by
        # reset_pending_index on role transitions; log-index domain
        self.pending_rel = np.ones(g, np.int32)
        self.voter_mask = np.zeros((g, p), bool)    # lane: no-shift — bool mask
        self.old_voter_mask = np.zeros((g, p), bool)  # lane: no-shift — bool mask
        # lane: no-conf no-shift — absolute committed index; a conf
        # change never moves what is already committed
        self.commit_abs = np.zeros(g, np.int64)
        # protocol plane (SURVEY §8.1): roles, deadlines, acks, votes
        # lane: no-conf no-shift — host-applied role transitions only
        # (set_conf never changes who leads); not time-valued
        self.role = np.full(g, ROLE_INACTIVE, np.int32)
        # lane: no-conf — deadlines re-arm on role transitions and leader
        # contact, not on membership changes
        self.elect_deadline = np.zeros(g, np.int64)
        # lane: no-conf — beat cadence is role-driven; set_conf's fresh
        # peers get their grace stamp through last_ack instead
        self.hb_deadline = np.zeros(g, np.int64)
        self.last_ack = np.full((g, p), _NEG_I32, np.int64)
        self.granted = np.zeros((g, p), bool)   # lane: no-shift — bool votes
        # lane: no-shift — column index, not time-valued
        self.self_col = np.full(g, -1, np.int32)
        # lane: no-conf no-shift — registration bit (register_ctrl /
        # unregister_ctrl own it); not time-valued
        self.has_ctrl = np.zeros(g, bool)
        # quiescence ("hibernate raft"): a True row suppresses the
        # group's hb_due/election_due masks on device; liveness rides
        # the store-level lease (HeartbeatHub).  Host-owned like role.
        # lane: no-conf no-shift — set_conf wakes a hibernating group
        # THROUGH EngineControl.wake_from_quiescence (which clears this
        # row and the hub lease bookkeeping together — a bare row write
        # here would leak the lease); not time-valued
        self.quiescent = np.zeros(g, bool)
        # read plane: the last tick's fused q_ack reduction ([G] q-th
        # newest voter ack, ms).  Acks only ever arrive, so a stale row
        # is a LOWER bound on the true quorum-ack time — a lease check
        # that passes against it is sound, and one that fails falls back
        # to the exact host-side [P] sort (EngineControl.lease_valid).
        self.tick_q_ack = np.full(g, _NEG_I32, np.int64)
        self.lease_lane_hits = 0     # lease reads answered off the row
        self.lease_lane_misses = 0   # fell back to the host-side sort
        # witness voters (either config): metadata-only replicas — they
        # vote and ack, but the device commit reduce clamps to the best
        # DATA-replica match (ballot.witness_commit_clamp).
        # lane: no-shift — bool mask
        self.witness_mask = np.zeros((g, p), bool)
        self._n_witness_slots = 0    # steady-state clamp skip when zero
        # periodic stepdown/priority lane (the reference's stepDownTimer,
        # eto/2): fires Node._check_dead_nodes for engine leaders —
        # dead-quorum re-verification AND priority_transfer_rounds
        # accrual (decay-elected leaders hand leadership back).
        # lane: no-conf — re-armed on leadership transitions (on_leader)
        # and every fire, never by membership changes
        self.stepdown_deadline = np.zeros(g, np.int64)
        self.stepdown_ticks = 0      # stepdown_due fires applied
        # device read-fence plane: earliest pending ReadConfirmBatcher
        # round start per slot (NEG = none); the tick's fence_ok lane
        # resolves rounds against the fused q_ack reduction instead of a
        # host-side per-ack set tally.
        self.fence_start = np.full(g, _NEG_I32, np.int64)
        self._fence_waiters: dict[int, list] = {}  # slot -> [(start, fence)]
        self.fence_lane_armed = 0    # rounds armed on the device lane
        self.fence_lane_resolves = 0  # rounds resolved by fence_ok
        # store-lease plumbing for QUIESCENT LEADER slots: endpoint ->
        # {slot: [cols]} of last_ack cells refreshed by one store-lease
        # ack from that endpoint (flattened index arrays cached per
        # endpoint) — dead-quorum step-down and leader-lease reads for
        # hibernating groups consult the store lease through these rows.
        self._lease_cols: dict[str, dict[int, list[int]]] = {}
        self._lease_arrays: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self.quiesce_events = 0   # groups that entered hibernation
        self.wake_events = 0      # groups woken (activity / lease expiry)
        self._peer_cols: list[dict[PeerId, int]] = [dict() for _ in range(g)]
        self._boxes: list[Optional[TpuBallotBox]] = [None] * g
        self._ctrls: list[Optional[EngineControl]] = [None] * g
        self._ctrl_server: list[Optional[PeerId]] = [None] * g
        self._free = list(range(g - 1, -1, -1))
        self._dirty = False
        self._dirty_event = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self._tick_fn = None  # the sharded tick's outputs, set by start()
        self._deadline_fold = None  # mesh mode: one fold a shard + host min
        self._mesh = None     # torch devices of the tick's shards (start())
        self._device = None   # the first shard's device
        self._params_dev = None  # TickParams of each shard
        self._staging = None  # a _TickStaging a shard, for the current G
        self._profiler = None  # torch.profiler window (profile_dir)
        self.ticks = 0
        self.commit_advances = 0
        # event-driven commit advancement (TickOptions.eager_commit):
        # quorums closed on the ack path by eager_commit_slot, without
        # waiting for the next device tick
        self.eager_commits = 0
        # device-tick profiling (fleet observability): per-tick wall
        # time attributed to the three phases every tick pays — host
        # state build, device dispatch (jit call + output transfer, or
        # the numpy twin), host apply (commit callbacks + protocol
        # scheduling).  Always on: four locked histogram updates per
        # TICK (not per op) — ticks are paced by their own cost, so
        # this stays noise even at max cadence.
        from tpuraft_torch.util.metrics import Histogram
        self.tick_hists = {
            "tick_total_ms": Histogram(),
            "tick_build_ms": Histogram(),
            "tick_device_ms": Histogram(),
            "tick_apply_ms": Histogram(),
        }
        # --profile-ticks window: a dedicated Tracer capturing one span
        # per tick phase for the next N ticks (perfetto timeline export
        # through the trace plane's exporter); None = disarmed (the
        # hot-path cost is one attribute test per tick)
        self._tick_tracer = None
        self._tick_prof_left = 0
        # protocol params: [G] rows — each registered node's NodeOptions
        # timeouts apply to ITS groups only (mixed-timeout engines, e.g.
        # a PD group + region groups in one process, run correct
        # per-group constants; was engine-wide first-node-wins pre-r3).
        # lane: no-conf no-shift — registration-derived parameters
        # (register_ctrl + the density floor own them); they are
        # durations, not absolute times, so the epoch shift skips them
        self.eto_ms = np.full(g, _DEF_ETO_MS, np.int64)
        # lane: no-conf no-shift — same registration-derived duration row
        self.hb_ms = np.full(g, _DEF_HB_MS, np.int64)
        # lane: no-conf no-shift — same registration-derived duration row
        self.lease_ms = np.full(g, _DEF_LEASE_MS, np.int64)
        # density-aware timeout floors: the REQUESTED NodeOptions values
        # per slot; the effective rows above are max(requested, derived
        # floor) with hb/lease scaled proportionally.  The floor grows
        # with registered group count and the measured tick cost, so a
        # 16K-group process lands on a safe operating point without the
        # hand-tuned 60s timeouts BENCH_SCALE previously required.
        # lane: no-conf no-shift — requested durations (register_ctrl
        # writes them; conf changes and the time epoch never do)
        self.req_eto_ms = np.full(g, _DEF_ETO_MS, np.int64)
        # lane: no-conf no-shift — same requested-duration row
        self.req_hb_ms = np.full(g, _DEF_HB_MS, np.int64)
        # lane: no-conf no-shift — same requested-duration row
        self.req_lease_ms = np.full(g, _DEF_LEASE_MS, np.int64)
        self._floor_applied_ms = 0
        self._tick_cost_ema_s = 0.0
        # the floor derivation scans every registered slot, so it runs
        # only at geometric registration counts (the floor is ~linear
        # in n, and the apply gate already tolerates 25% staleness) —
        # a 16K-group boot pays O(G) total floor work, not O(G^2)
        self._n_ctrls = 0
        self._floor_cached_ms = 0
        self._floor_next_n = 0
        # engine-scheduled snapshot cadence (the reference's 4th timer,
        # snapshotTimer): [G] interval row (0 = disabled) + deadline row
        # replace G per-group RepeatedTimers; fires staggered by jitter.
        # lane: no-conf no-shift — interval duration owned by
        # register_ctrl; membership changes don't move the cadence
        self.snap_ms = np.zeros(g, np.int64)
        # lane: no-conf — snapshot cadence is registration-driven, not
        # membership-driven (the deadline row IS epoch-shifted)
        self.snap_deadline = np.zeros(g, np.int64)
        # injectable store clock (ISSUE 18): the engine's whole time
        # plane — deadlines, ack stamps, leases — runs on this clock,
        # so a ChaosClock skews the STORE exactly like a bad machine
        self._clock = clockmod.resolve(self.opts.clock)
        self._t0 = self._clock.monotonic()

    # -- time ----------------------------------------------------------------

    def now_ms(self) -> int:
        return int((self._clock.monotonic() - self._t0) * 1000)

    def to_ms(self, monotonic_time: float) -> int:
        return int((monotonic_time - self._t0) * 1000)

    def _maybe_time_rebase(self, now: int) -> None:
        """Shift the time epoch before int32 ms overflows (~12 days)."""
        if now < _TIME_REBASE_MS:
            return
        shift = now - int(self.eto_ms.max()) * 4
        self._t0 += shift / 1000.0
        self.elect_deadline -= shift
        self.hb_deadline -= shift
        self.snap_deadline -= shift
        self.stepdown_deadline -= shift
        np.maximum(self.last_ack - shift, _NEG_I32, out=self.last_ack)
        np.maximum(self.tick_q_ack - shift, _NEG_I32, out=self.tick_q_ack)
        # NEG rows stay NEG (no fence pending); armed rows shift with
        # the epoch like the ack stamps they are compared against
        np.maximum(self.fence_start - shift, _NEG_I32, out=self.fence_start)
        for waiters in self._fence_waiters.values():
            waiters[:] = [(max(start - shift, _NEG_I32 + 1), fence)
                          for start, fence in waiters]

    # -- registry ------------------------------------------------------------

    def ballot_box_factory(self):
        """Returns a factory usable as Node(ballot_box_factory=...)."""

        def make(on_committed: Callable[[int], None]) -> TpuBallotBox:
            slot = self.alloc_slot()
            box = TpuBallotBox(self, slot, on_committed)
            self._boxes[slot] = box
            return box

        return make

    def register_ctrl(self, ctrl: EngineControl, server_id: PeerId,
                      eto_ms: int, hb_ms: int, lease_ms: int,
                      snapshot_ms: int = 0) -> int:
        """Register a node's control plane.  Returns the EFFECTIVE
        election timeout for the slot — the requested value raised to the
        engine's density floor when the process hosts more groups than
        the requested timeout can beat within the cpu budget."""
        s = ctrl.slot
        self._ctrls[s] = ctrl
        self._ctrl_server[s] = server_id
        self.has_ctrl[s] = True
        col = self._peer_cols[s].get(server_id)
        self.self_col[s] = -1 if col is None else col
        self.req_eto_ms[s], self.req_hb_ms[s], self.req_lease_ms[s] = \
            eto_ms, hb_ms, lease_ms
        self._n_ctrls += 1
        if self._n_ctrls >= self._floor_next_n:
            self._floor_cached_ms = self._density_floor_ms()
            self._floor_next_n = int(self._n_ctrls * 1.25) + 1
        floor = self._floor_cached_ms
        if floor > self._floor_applied_ms * 1.25:
            # the floor grew materially (more groups / slower ticks):
            # re-derive every controlled slot's effective rows.  Gated
            # to >25% growth so a 16K-registration boot costs O(G log G)
            # row rewrites, not O(G^2).
            self._floor_applied_ms = floor
            self._reapply_floor()
        else:
            self._apply_floor_slot(s)
        self.snap_ms[s] = snapshot_ms
        if snapshot_ms > 0:
            # first due staggered over [0.5, 1.5) intervals: groups
            # registered together must not snapshot as one herd
            self.snap_deadline[s] = self.now_ms() + int(
                snapshot_ms * (0.5 + random.random()))
        self._params_dev = None  # (re)built at next device tick
        return int(self.eto_ms[s])

    # -- density-aware timeout floors ---------------------------------------

    def _density_floor_ms(self) -> int:
        """Minimum safe election timeout at the CURRENT registered
        density, derived from group count and measured costs instead of
        operator hand-tuning.  Two terms:

        - beat-budget: idle beats/s = groups x followers x factor /
          eto_s; each beat costs ~``beat_cost_us`` end to end, and the
          idle beat plane may use at most ``beat_cpu_budget`` of one
          core — solve for eto.
        - tick-cost: one heartbeat interval must dwarf a measured tick
          dispatch (x50), or the engine cannot keep every group's beat
          schedule — a tunneled/slow device raises the floor on its own.
        """
        if not self.opts.density_aware_timeouts:
            return 0
        n = int(self.has_ctrl.sum())
        if n == 0:
            return 0
        vm = self.voter_mask[self.has_ctrl]
        per = np.clip(vm.sum(axis=1) - 1, 0, None)
        followers = float(per.mean()) if per.size else 2.0
        req_eto = self.req_eto_ms[self.has_ctrl].astype(np.float64)
        req_hb = np.maximum(self.req_hb_ms[self.has_ctrl], 1)
        factor = float((req_eto / req_hb).mean()) if req_eto.size else 10.0
        beat_term = (n * followers * factor * self.opts.beat_cost_us
                     / (max(self.opts.beat_cpu_budget, 1e-3) * 1000.0))
        tick_term = self._tick_cost_ema_s * 1000.0 * factor * 50.0
        return int(max(beat_term, tick_term))

    def _apply_floor_slot(self, s: int) -> None:
        floor = self._floor_applied_ms
        req = int(self.req_eto_ms[s])
        if req >= floor or floor <= 0:
            self.eto_ms[s] = self.req_eto_ms[s]
            self.hb_ms[s] = self.req_hb_ms[s]
            self.lease_ms[s] = self.req_lease_ms[s]
            return
        ratio = floor / max(req, 1)
        self.eto_ms[s] = floor
        self.hb_ms[s] = max(1, int(self.req_hb_ms[s] * ratio))
        self.lease_ms[s] = max(1, int(self.req_lease_ms[s] * ratio))

    def _reapply_floor(self) -> None:
        floor = self._floor_applied_ms
        changed = 0
        for s in np.nonzero(self.has_ctrl)[0]:
            before = int(self.eto_ms[s])
            self._apply_floor_slot(int(s))
            after = int(self.eto_ms[s])
            if after != before:
                changed += 1
                ctrl = self._ctrls[s]
                if ctrl is not None:
                    ctrl._adopt_eto(after)
        if changed:
            LOG.info("engine density floor %dms raised %d groups' "
                     "election timeouts (%d registered)",
                     floor, changed, int(self.has_ctrl.sum()))
        self._params_dev = None

    def unregister_ctrl(self, slot: int) -> None:
        # idempotent per REGISTRATION, not per call: a controlled node's
        # shutdown reaches here twice (EngineControl.shutdown, then
        # ballot_box.close -> release), and a bare commit-plane box
        # (drive_protocol off) releases without ever registering — an
        # unconditional decrement drifted _n_ctrls negative under churn,
        # and the density-floor recompute trigger (_n_ctrls >=
        # _floor_next_n in register_ctrl) could then stay silent while
        # the REAL controlled density grew past the safe operating point
        if self.has_ctrl[slot]:
            self._n_ctrls -= 1
        self._ctrls[slot] = None
        self._ctrl_server[slot] = None
        self.has_ctrl[slot] = False
        self.self_col[slot] = -1

    def alloc_slot(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def _grow(self) -> None:
        """Double group capacity in place.  Region splits mint new raft
        groups at runtime; a full engine must absorb them, not crash
        the new RegionEngine.  The next tick recompiles once for the
        new shape (jit caches per shape); doubling preserves
        divisibility by mesh_devices for the sharded path."""
        old_g = self.G
        new_g = old_g * 2

        def pad(a: np.ndarray, fill=0) -> np.ndarray:
            extra = np.full((old_g,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, extra])

        self.match_abs = pad(self.match_abs)
        self.base = pad(self.base)
        self.pending_rel = pad(self.pending_rel, 1)
        self.voter_mask = pad(self.voter_mask)
        self.old_voter_mask = pad(self.old_voter_mask)
        self.commit_abs = pad(self.commit_abs)
        self.role = pad(self.role, ROLE_INACTIVE)
        self.elect_deadline = pad(self.elect_deadline)
        self.hb_deadline = pad(self.hb_deadline)
        self.last_ack = pad(self.last_ack, _NEG_I32)
        self.tick_q_ack = pad(self.tick_q_ack, _NEG_I32)
        self.witness_mask = pad(self.witness_mask)
        self.stepdown_deadline = pad(self.stepdown_deadline)
        self.fence_start = pad(self.fence_start, _NEG_I32)
        self.granted = pad(self.granted)
        self.self_col = pad(self.self_col, -1)
        self.has_ctrl = pad(self.has_ctrl)
        self.quiescent = pad(self.quiescent)
        self.eto_ms = pad(self.eto_ms, _DEF_ETO_MS)
        self.hb_ms = pad(self.hb_ms, _DEF_HB_MS)
        self.lease_ms = pad(self.lease_ms, _DEF_LEASE_MS)
        self.req_eto_ms = pad(self.req_eto_ms, _DEF_ETO_MS)
        self.req_hb_ms = pad(self.req_hb_ms, _DEF_HB_MS)
        self.req_lease_ms = pad(self.req_lease_ms, _DEF_LEASE_MS)
        self.snap_ms = pad(self.snap_ms)
        self.snap_deadline = pad(self.snap_deadline)
        self._params_dev = None  # [G] rows must match the grown shape
        self._peer_cols.extend(dict() for _ in range(old_g))
        self._boxes.extend([None] * old_g)
        self._ctrls.extend([None] * old_g)
        self._ctrl_server.extend([None] * old_g)
        self._free = list(range(new_g - 1, old_g - 1, -1))
        self.G = new_g
        LOG.info("engine grew: %d -> %d group slots", old_g, new_g)

    def release(self, box: TpuBallotBox) -> None:
        s = box.slot
        self._boxes[s] = None
        self.unregister_ctrl(s)
        self.voter_mask[s] = False
        self.old_voter_mask[s] = False
        self.match_abs[s] = 0
        self.commit_abs[s] = 0
        self.base[s] = 0
        self.pending_rel[s] = 1
        self.role[s] = ROLE_INACTIVE
        self.elect_deadline[s] = 0
        self.hb_deadline[s] = 0
        self.last_ack[s] = _NEG_I32
        self.tick_q_ack[s] = _NEG_I32
        if self.witness_mask[s].any():
            self._n_witness_slots -= 1
        self.witness_mask[s] = False
        self.stepdown_deadline[s] = 0
        self.fence_start[s] = _NEG_I32
        # pending fences die with the slot; the batcher round's timeout
        # sweep resolves their futures False
        self._fence_waiters.pop(s, None)
        self.granted[s] = False
        self.quiescent[s] = False
        self.note_wake_leader(s)
        self.eto_ms[s], self.hb_ms[s], self.lease_ms[s] = \
            _DEF_ETO_MS, _DEF_HB_MS, _DEF_LEASE_MS
        self.req_eto_ms[s], self.req_hb_ms[s], self.req_lease_ms[s] = \
            _DEF_ETO_MS, _DEF_HB_MS, _DEF_LEASE_MS
        self.snap_ms[s] = 0
        self.snap_deadline[s] = 0
        self._params_dev = None
        self._peer_cols[s].clear()
        self._free.append(s)

    def set_conf(self, slot: int, conf: Configuration,
                 old_conf: Configuration) -> None:
        """Map peers to columns and set voter masks for a group."""
        cols = self._peer_cols[slot]
        all_peers = list(dict.fromkeys(
            conf.peers + old_conf.peers + conf.learners + old_conf.learners))
        # retain existing column assignments; add new peers to free columns
        used = set(cols.values())
        for peer in all_peers:
            if peer not in cols:
                col = next((i for i in range(self.P) if i not in used), None)
                if col is None:
                    raise RuntimeError(
                        f"group slot {slot}: {len(all_peers)} distinct peers "
                        f"exceed max_peers={self.P} engine columns")
                cols[peer] = col
                used.add(col)
        # drop stale peers
        for peer in [p for p in cols if p not in all_peers]:
            self.match_abs[slot, cols[peer]] = 0
            self.last_ack[slot, cols[peer]] = _NEG_I32
            self.granted[slot, cols[peer]] = False
            del cols[peer]
        vm = np.zeros(self.P, bool)
        ovm = np.zeros(self.P, bool)
        wm = np.zeros(self.P, bool)
        for peer in conf.peers:
            vm[cols[peer]] = True
        for peer in old_conf.peers:
            ovm[cols[peer]] = True
        # witness columns (either config): the union mirrors the host
        # BallotBox clamp's data set `conf.data_peers + old_conf
        # .data_peers` — a column is data only if NEITHER config marks
        # it witness
        for peer in getattr(conf, "witnesses", ()) or ():
            if peer in cols:
                wm[cols[peer]] = True
        for peer in getattr(old_conf, "witnesses", ()) or ():
            if peer in cols:
                wm[cols[peer]] = True
        had_witness = bool(self.witness_mask[slot].any())
        self.voter_mask[slot] = vm
        self.old_voter_mask[slot] = ovm
        self.witness_mask[slot] = wm
        self._n_witness_slots += int(wm.any()) - int(had_witness)
        # the cached read-plane q_ack was reduced over the OLD voter set;
        # a shrunk conf can make it overstate the new quorum's freshness
        # (no longer a lower bound) — drop it until the next tick
        self.tick_q_ack[slot] = _NEG_I32
        # pending read fences were armed against the old voter set too:
        # drop the device lane for them (the batcher round's own timeout
        # resolves their futures; a conf change mid-round is rare)
        if self.fence_start[slot] > _NEG_I32:
            self.fence_start[slot] = _NEG_I32
            self._fence_waiters.pop(slot, None)
        if self.role[slot] == ROLE_LEADER:
            # grace window for peers ADDED mid-leadership (reference:
            # addReplicator stamps lastRpcSendTimestamp at start): a
            # never-acked NEG column would otherwise pin the joint q_ack
            # reduce at NEG_INF, which the have-ack gate reads as "no
            # data" — so a dead new config could never fire step_down.
            # Invariant: a leader's (old_)voter columns are never NEG.
            row = self.last_ack[slot]
            fresh = (vm | ovm) & (row <= _NEG_I32)
            if fresh.any():
                row[fresh] = self.now_ms()
        server = self._ctrl_server[slot]
        if server is not None:
            col = cols.get(server)
            self.self_col[slot] = -1 if col is None else col
        if self.quiescent[slot]:
            # a configuration change is protocol activity: a hibernating
            # group must wake to drive it (and its lease bookkeeping no
            # longer matches the new peer set)
            ctrl = self._ctrls[slot]
            if ctrl is not None:
                ctrl.wake_from_quiescence("conf-change")
        self.mark_dirty()

    def peer_col(self, slot: int, peer: PeerId) -> Optional[int]:
        return self._peer_cols[slot].get(peer)

    def mark_dirty(self) -> None:
        self._dirty = True
        self._dirty_event.set()

    # -- device read-fence plane (ReadConfirmBatcher rounds) -----------------

    def arm_read_fence(self, slot: int, fence) -> None:
        """Queue a SAFE ReadIndex round on the device tally: the round
        is confirmed once the fused q_ack reduction shows a voter quorum
        acked at-or-after *now*.  ``fence_start[slot]`` carries the
        EARLIEST pending round's start (a q_ack covering it covers every
        later round the resolve pass walks)."""
        start = self.now_ms()
        self._fence_waiters.setdefault(slot, []).append((start, fence))
        cur = self.fence_start[slot]
        self.fence_start[slot] = start if cur <= _NEG_I32 else min(cur, start)
        self.fence_lane_armed += 1
        self.mark_dirty()

    def discard_read_fence(self, slot: int, fence) -> None:
        """Drop one fence from the device lane (round end/timeout) and
        re-derive the row's earliest pending start.  Idempotent — a
        fence the resolve pass already removed just isn't found."""
        waiters = self._fence_waiters.get(slot)
        if not waiters:
            return
        keep = [(start, f) for start, f in waiters if f is not fence]
        if keep:
            self._fence_waiters[slot] = keep
            self.fence_start[slot] = min(start for start, _ in keep)
        else:
            self._fence_waiters.pop(slot, None)
            self.fence_start[slot] = _NEG_I32

    def _resolve_fences(self, s: int) -> None:
        """fence_ok fired for slot ``s``: confirm every pending round
        whose start the published q_ack covers, drop abandoned fences,
        re-arm the row to the earliest still-pending start."""
        waiters = self._fence_waiters.get(s)
        if not waiters:
            self.fence_start[s] = _NEG_I32
            return
        qa = int(self.tick_q_ack[s])
        keep = []
        for start, fence in waiters:
            if start <= qa:
                self.fence_lane_resolves += 1
                fence.note_quorum()
            elif not fence.done:
                keep.append((start, fence))
        if keep:
            self._fence_waiters[s] = keep
            self.fence_start[s] = min(start for start, _ in keep)
        else:
            self._fence_waiters.pop(s, None)
            self.fence_start[s] = _NEG_I32

    # -- store-lease plumbing (quiescent leader slots) -----------------------

    def note_quiesce_leader(self, slot: int) -> None:
        """A leader slot hibernated: its peers' last_ack cells are now
        refreshed from store-lease acks (one per endpoint per interval)
        instead of per-group beat acks."""
        self_col = int(self.self_col[slot])
        for peer, col in self._peer_cols[slot].items():
            if col == self_col:
                continue
            d = self._lease_cols.setdefault(peer.endpoint, {})
            d.setdefault(slot, []).append(col)
            self._lease_arrays.pop(peer.endpoint, None)

    def note_wake_leader(self, slot: int) -> None:
        for ep in list(self._lease_cols):
            if self._lease_cols[ep].pop(slot, None) is not None:
                self._lease_arrays.pop(ep, None)
                if not self._lease_cols[ep]:
                    del self._lease_cols[ep]

    def note_store_ack(self, endpoint: str,
                       when_ms: Optional[int] = None) -> None:
        """A store-lease ack from ``endpoint``: refresh every quiescent
        leader slot's last_ack cells toward it (vectorized — one fancy-
        indexed write per ack, not O(G) RPC bookkeeping).  Dead-quorum
        step-down and leader-lease reads then see a live quorum for
        hibernating groups exactly as long as the store lease flows."""
        d = self._lease_cols.get(endpoint)
        if not d:
            return
        arrs = self._lease_arrays.get(endpoint)
        if arrs is None:
            slots: list[int] = []
            cols: list[int] = []
            for s, cs in d.items():
                slots.extend([s] * len(cs))
                cols.extend(cs)
            arrs = (np.asarray(slots, np.int64), np.asarray(cols, np.int64))
            self._lease_arrays[endpoint] = arrs
        ms = self.now_ms() if when_ms is None else when_ms
        sl, co = arrs
        self.last_ack[sl, co] = np.maximum(self.last_ack[sl, co], ms)

    def describe(self) -> str:
        """Live engine state for operators (the device-plane counterpart
        of Node#describe)."""
        used = sum(1 for b in self._boxes if b is not None)
        return (f"MultiRaftEngine<G={self.G} P={self.P} used={used} "
                f"ctrl={int(self.has_ctrl.sum())} "
                f"backend={self.opts.backend} "
                f"mesh={self.opts.mesh_devices or 1} "
                f"ticks={self.ticks} commit_advances={self.commit_advances} "
                f"eager_commits={self.eager_commits} "
                f"leaders={int((self.role == ROLE_LEADER).sum())} "
                f"quiescent={int(self.quiescent.sum())} "
                f"quiesce_events={self.quiesce_events} "
                f"wake_events={self.wake_events} "
                f"lease_lane_hits={self.lease_lane_hits} "
                f"lease_lane_misses={self.lease_lane_misses} "
                f"witness_groups={self._n_witness_slots} "
                f"stepdown_ticks={self.stepdown_ticks} "
                f"fence_armed={self.fence_lane_armed} "
                f"fence_resolves={self.fence_lane_resolves} "
                f"eto_floor_ms={self._floor_applied_ms} "
                f"tick_p99_ms={self.tick_hists['tick_total_ms'].percentile(99):.3f}>")

    # -- device-tick profiling (fleet observability) -------------------------

    def tick_histograms(self) -> dict:
        """Per-tick phase wall-time histograms as snapshot dicts — the
        shape ``prometheus_text(histograms=...)`` renders (served by
        StoreEngine.metrics_text for engine-backed stores)."""
        return {k: h.snapshot() for k, h in self.tick_hists.items()}

    def lane_stats(self) -> dict:
        """[G]-lane occupancy gauges, computed as vectorized reductions
        over the host mirrors the tick already owns — no per-group
        Python.  ``hibernation_fraction`` is quiescent/controlled (the
        number the PD's ClusterView aggregates fleet-wide)."""
        hc = self.has_ctrl
        n = int(hc.sum())
        leaders = int(((self.role == ROLE_LEADER) & hc).sum())
        quiescent = int((self.quiescent & hc).sum())
        stats = {
            "groups": n,
            "leaders": leaders,
            "candidates": int(((self.role == ROLE_CANDIDATE) & hc).sum()),
            "followers": int(((self.role == ROLE_FOLLOWER) & hc).sum()),
            "quiescent": quiescent,
            "hibernation_fraction": round(quiescent / n, 4) if n else 0.0,
            "tick_cost_ema_ms": round(self._tick_cost_ema_s * 1e3, 3),
            "witness_groups": self._n_witness_slots,
            "stepdown_ticks": self.stepdown_ticks,
            "fence_lane_armed": self.fence_lane_armed,
            "fence_lane_resolves": self.fence_lane_resolves,
            "fences_pending": sum(len(w) for w
                                  in self._fence_waiters.values()),
        }
        # q_ack distribution: age of the quorum-newest ack per AWAKE
        # leader row (quiescent leaders ride the store lease; their rows
        # age by design and would drown the signal) — the read plane's
        # lease headroom at a glance
        lead = (self.role == ROLE_LEADER) & hc & ~self.quiescent
        qa = self.tick_q_ack[lead]
        qa = qa[qa > _NEG_I32]
        if qa.size:
            ages = np.clip(self.now_ms() - qa, 0, None)
            stats["q_ack_age_ms_p50"] = float(np.percentile(ages, 50))
            stats["q_ack_age_ms_p99"] = float(np.percentile(ages, 99))
            stats["q_ack_age_ms_max"] = float(ages.max())
        else:
            stats["q_ack_age_ms_p50"] = 0.0
            stats["q_ack_age_ms_p99"] = 0.0
            stats["q_ack_age_ms_max"] = 0.0
        return stats

    def profile_ticks(self, n: int) -> None:
        """Arm a profiling window: the next ``n`` ticks each record a
        root span + build/device/apply phase spans into a dedicated
        tracer (sample_rate=1, no slow trigger), exportable as a
        perfetto timeline via :meth:`export_tick_timeline`.  Disarmed
        (the steady state) the tick pays one attribute test."""
        from tpuraft_torch.util.trace import Tracer

        if n <= 0:
            self._tick_tracer = None
            self._tick_prof_left = 0
            return
        self._tick_tracer = Tracer().configure(
            enabled=True, sample_rate=1.0, seed=0,
            ring=max(4096, 4 * n + 8), slow_trigger=False)
        self._tick_prof_left = n

    def _profile_tick(self, t0: float, t1: float, t2: float, t3: float,
                      advanced: int) -> None:
        # direct-emit path (odd tid = "record unconditionally"): the
        # spans carry their own measured [t0,t1] intervals, so staging
        # through begin_op/end_op would mis-stamp the root.  One tid
        # for the whole window keeps every tick on one perfetto track,
        # with the phase spans nesting inside each tick span.
        tr = self._tick_tracer
        tid = 1
        tr.span(tid, "tick", t0, t3, proc="engine", seq=self.ticks,
                advanced=advanced,
                groups=int(self.has_ctrl.sum()),
                quiescent=int((self.quiescent & self.has_ctrl).sum()))
        tr.span(tid, "tick_build", t0, t1, proc="engine")
        tr.span(tid, "tick_device", t1, t2, proc="engine")
        tr.span(tid, "tick_apply", t2, t3, proc="engine")
        self._tick_prof_left -= 1
        if self._tick_prof_left <= 0:
            self._tick_prof_left = 0
            # keep the tracer for export; stop recording
            self._tick_tracer, self._tick_trace_done = None, tr

    def export_tick_timeline(self, path: str) -> int:
        """Write the captured (or in-flight) --profile-ticks window as
        perfetto-loadable chrome trace JSON; returns the span count
        (0 = no window was armed)."""
        tr = self._tick_tracer or getattr(self, "_tick_trace_done", None)
        if tr is None:
            return 0
        return tr.export_chrome(path)

    # -- tick loop -----------------------------------------------------------

    def _resolve_backend(self) -> str:
        """The tick backend the caller asked for — never a silent
        substitute: "torch" runs on ``TickOptions.device`` (start()
        raises when that names a card that does not exist); "numpy" is
        the explicit host twin."""
        b = self.opts.backend
        if b not in ("torch", "numpy"):
            raise ValueError(f"unknown tick backend {b!r} "
                             "(expected 'torch' or 'numpy')")
        return b

    def _resolve_mesh(self):
        """The tick's shards: ``TickOptions.device`` alone, or with
        ``mesh_devices=N > 1`` N shards along the group axis — N
        distinct cards for "cuda", N logical shards for "cpu", or the N
        devices of a list (which may name one card several times)."""
        import torch

        from tpuraft_torch.parallel.mesh import make_mesh

        n = self.opts.mesh_devices or 1
        devs = self.opts.device
        if isinstance(devs, (list, tuple)):
            if len(devs) != n:
                raise ValueError(
                    f"TickOptions.device lists {len(devs)} devices but "
                    f"mesh_devices={self.opts.mesh_devices}")
        elif n == 1:
            dev = torch.device(devs)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"TickOptions(device={devs!r}) but no CUDA device is "
                    "available; pass device='cpu' or backend='numpy' to "
                    "run the tick on the host")
        if self.G % n != 0:
            raise ValueError(
                f"max_groups={self.G} not divisible by mesh_devices={n}")
        # raises if fewer cards exist than the mesh asks for
        return make_mesh(n, devs)

    async def start(self) -> None:
        if self._resolve_backend() == "torch":
            from tpuraft_torch.parallel.mesh import (sharded_deadline_fold,
                                                     sharded_tick_outputs)

            mesh = self._resolve_mesh()
            if any(d.type == "cuda" for d in mesh):
                from tpuraft_torch.ops import quorum_cuda

                # build + load the kernel library (the fused tick and the
                # deadline fold) NOW, before any node registers: a
                # multi-second nvcc build mid-protocol would block the
                # event loop and miss every group's heartbeat window at
                # once
                quorum_cuda.load()
            self._mesh, self._device = mesh, mesh[0]
            # each shard's rows advance on its own device: one launch a
            # shard, and only the [G] output rows come back to the host
            self._tick_fn = sharded_tick_outputs(mesh)
            if len(mesh) > 1:
                # earliest-deadline scan as one fold a shard and a min
                # of N values, instead of a host scan over every row
                self._deadline_fold = sharded_deadline_fold(mesh)
            # warm tick (first launch, staging buffers) before any node
            # registers, for the same reason
            self.tick_once()
        if self.opts.profile_dir:
            if self._resolve_backend() == "numpy":
                LOG.warning("profile_dir set but backend is numpy: the "
                            "torch profiler only traces the torch tick")
            else:
                import torch

                acts = [torch.profiler.ProfilerActivity.CPU]
                if any(d.type == "cuda" for d in self._mesh):
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                try:
                    # one profiler per process: a second engine keeps
                    # running without a trace instead of failing startup
                    prof = torch.profiler.profile(activities=acts)
                    prof.start()
                    self._profiler = prof
                except Exception as e:  # noqa: BLE001
                    LOG.warning("profiler trace not started (another "
                                "engine's trace active?): %s", e)
        from tpuraft_torch.util import describer

        describer.register(self)
        self._task = asyncio.ensure_future(self._loop())

    async def shutdown(self) -> None:
        self._stopped = True
        from tpuraft_torch.util import describer

        describer.unregister(self)
        if self._profiler is not None:
            import os

            prof, self._profiler = self._profiler, None
            try:
                prof.stop()
                os.makedirs(self.opts.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    self.opts.profile_dir, f"engine_ticks_{id(self)}.json"))
            except Exception as e:  # noqa: BLE001 — trace already stopped
                LOG.warning("profiler stop: %s", e)
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def _next_deadline(self) -> int:
        """Earliest engine-scheduled deadline (election, heartbeat or
        stepdown check) over controlled slots; a huge sentinel when
        none.  Quiescent slots schedule NOTHING — a fully hibernated
        engine sleeps until a dirty mark (wake, lease round, client
        traffic) arrives.  Mesh mode folds the scan on device (one
        sharded reduction + collective min) instead of gathering every
        sharded row back per loop iteration."""
        if self._deadline_fold is not None:
            from tpuraft_torch.parallel.mesh import DEADLINE_NONE_I32

            nxt = int(self._deadline_fold(
                self.role, self.quiescent, self.has_ctrl,
                self.elect_deadline.astype(np.int32),
                self.hb_deadline.astype(np.int32),
                self.stepdown_deadline.astype(np.int32)))
            return (1 << 60) if nxt >= int(DEADLINE_NONE_I32) else nxt
        hc = self.has_ctrl & ~self.quiescent
        ec = hc & ((self.role == ROLE_FOLLOWER) | (self.role == ROLE_CANDIDATE))
        ld = hc & (self.role == ROLE_LEADER)
        nxt = 1 << 60
        if ec.any():
            nxt = min(nxt, int(self.elect_deadline[ec].min()))
        if ld.any():
            nxt = min(nxt, int(self.hb_deadline[ld].min()))
            nxt = min(nxt, int(self.stepdown_deadline[ld].min()))
        return nxt

    async def _loop(self) -> None:
        """Adaptive cadence: dirty -> tick now (sub-ms commit ack at low
        load); consecutive ticks pace by the previous tick's cost (a
        tunneled device batches more per dispatch); idle -> sleep to the
        next deadline, capped at tick_interval_ms."""
        max_idle_s = self.opts.tick_interval_ms / 1000.0
        min_pace_s = self.opts.min_tick_interval_ms / 1000.0
        while not self._stopped:
            now = self.now_ms()
            due = self._next_deadline() <= now
            if self._dirty or due:
                self._dirty_event.clear()
                self._dirty = False
                t0 = time.perf_counter()
                advanced = 0
                try:
                    advanced = self.tick_once()
                except Exception:
                    LOG.exception("engine tick failed")
                    self._dirty = True  # re-process pending acks next tick
                dur = time.perf_counter() - t0
                # measured tick dispatch cost: one input to the density-
                # aware election-timeout floor (_density_floor_ms)
                self._tick_cost_ema_s = (
                    dur if self._tick_cost_ema_s == 0.0
                    else 0.9 * self._tick_cost_ema_s + 0.1 * dur)
                pace = max(min_pace_s, dur * self.opts.pace_factor)
                if advanced == 0:
                    # a no-op tick (e.g. the leader's OWN ack before any
                    # follower responded) must not make the next real
                    # ack wait out the full pace window — that alone
                    # added ~1.5ms to the low-load commit-ack path.
                    # Debounce briefly (bounds tick spin under dirty
                    # storms), then let a dirty mark cut the remainder.
                    await asyncio.sleep(min(pace, 0.0003))
                    try:
                        await asyncio.wait_for(self._dirty_event.wait(),
                                               pace)
                    except asyncio.TimeoutError:
                        pass
                else:
                    await asyncio.sleep(pace)
                continue
            wait = min(max_idle_s,
                       max(0.0, (self._next_deadline() - now) / 1000.0))
            if self._dirty:
                continue
            try:
                await asyncio.wait_for(self._dirty_event.wait(), wait)
            except asyncio.TimeoutError:
                pass

    # -- the tick ------------------------------------------------------------

    def _rebase(self) -> None:
        hot = (self.match_abs.max(axis=1) - self.base) > _REBASE_LIMIT
        if hot.any():
            for s in np.nonzero(hot)[0]:
                new_base = self.commit_abs[s]
                self.pending_rel[s] = max(
                    1, self.pending_rel[s] - (new_base - self.base[s]))
                self.base[s] = new_base

    def tick_once(self) -> int:
        """One batched device tick for all groups: commit advancement,
        election/heartbeat scheduling, lease & step-down.  Returns the
        number of groups whose commit advanced."""
        t0 = time.perf_counter()
        now = self.now_ms()
        self._maybe_time_rebase(now)
        now = self.now_ms()
        self._rebase()
        # the leader's own slot counts as acked *now* (tick.py contract)
        lead_rows = np.nonzero((self.role == ROLE_LEADER)
                               & (self.self_col >= 0))[0]
        if lead_rows.size:
            self.last_ack[lead_rows, self.self_col[lead_rows]] = now
        rel = np.clip(self.match_abs - self.base[:, None], 0, None
                      ).astype(np.int32)
        commit_rel_now = np.clip(self.commit_abs - self.base, 0, None
                                 ).astype(np.int32)

        t1 = time.perf_counter()
        if self._tick_fn is not None:
            out = self._device_tick(rel, commit_rel_now, now)
        elif self.opts.backend == "numpy":  # the explicit host twin
            out = self._np_tick(rel, commit_rel_now, now)
        else:
            raise RuntimeError("backend='torch' engine ticked before "
                               "start(): no device tick to run")
        t2 = time.perf_counter()

        self.ticks += 1
        # publish the read-plane lane: the fused q_ack reduce is exactly
        # what per-read lease checks need, and the row it replaces is a
        # per-read [P] copy+sort on the hot GET path
        np.copyto(self.tick_q_ack, np.asarray(out.q_ack))
        advanced = self._apply_commits(out)
        self._apply_protocol(out, now)
        t3 = time.perf_counter()
        self.tick_hists["tick_build_ms"].update((t1 - t0) * 1e3)
        self.tick_hists["tick_device_ms"].update((t2 - t1) * 1e3)
        self.tick_hists["tick_apply_ms"].update((t3 - t2) * 1e3)
        self.tick_hists["tick_total_ms"].update((t3 - t0) * 1e3)
        if self._tick_tracer is not None:
            self._profile_tick(t0, t1, t2, t3, advanced)
        return advanced

    def _device_tick(self, rel, commit_rel_now, now):
        """One torch tick, per shard: the 15 state mirrors of the
        shard's rows go up in ONE non-blocking copy from a pinned
        staging buffer, the tick (one fused-tick launch on CUDA) writes
        its 11 outputs packed into a device buffer, and they come back
        in ONE copy; the host waits once for every shard — per-field
        synchronous copies would make copy latency the tick's cost."""
        import torch

        from tpuraft_torch.ops.tick import GroupState, TickParams
        from tpuraft_torch.parallel.mesh import group_slices, shard_params

        mesh = self._mesh
        if self._params_dev is None:
            self._params_dev = shard_params(TickParams.make(
                self.eto_ms, self.hb_ms, self.lease_ms, self.snap_ms,
                device="cpu"), mesh, self.G)
        if self._staging is None or sum(
                st.g for st in self._staging) != self.G:
            self._staging = [
                _TickStaging(self.G // len(mesh), self.P, dev, rows)
                for dev, rows in zip(mesh, group_slices(self.G, len(mesh)))]
        stagings = self._staging
        for st in stagings:
            st.fill(self, rel, commit_rel_now)
        with torch.profiler.record_function("tpuraft.raft_tick"):
            states = [GroupState(**st.upload()) for st in stagings]
            self._tick_fn(states, now, self._params_dev,
                          [st.out_dev for st in stagings])
            for st in stagings:
                st.fetch()
            for dev in {d for d in mesh if d.type == "cuda"}:
                torch.cuda.current_stream(dev).synchronize()
            parts = [st.landed() for st in stagings]
        if len(parts) == 1:
            return _NpOutputs(**parts[0])
        return _NpOutputs(**{k: np.concatenate([p[k] for p in parts])
                             for k in parts[0]})

    def _np_tick(self, rel, commit_rel_now, now) -> _NpOutputs:
        """Bit-exact numpy twin of tpuraft_torch.ops.tick.raft_tick (the
        backend="numpy" tick, chosen explicitly; also the oracle in
        engine tests)."""
        vm, ovm = self.voter_mask, self.old_voter_mask
        is_leader = self.role == ROLE_LEADER
        is_follower = self.role == ROLE_FOLLOWER
        is_candidate = self.role == ROLE_CANDIDATE

        q = _np_joint_quorum(rel, vm, ovm)
        if self._n_witness_slots:
            # witness commit clamp (ballot.witness_commit_clamp's numpy
            # twin): acked-by-witnesses-only indexes are not durable —
            # clamp to the best data-replica match.  Skipped entirely
            # while no registered conf carries witnesses (the steady
            # state for most engines).
            voters = vm | ovm
            wm = self.witness_mask
            has_w = (voters & wm).any(axis=1)
            data_best = np.where(voters & ~wm, rel, 0).max(axis=1)
            q = np.where(has_w, np.minimum(q, data_best), q).astype(np.int32)
        can_commit = is_leader & (q >= self.pending_rel)
        new_commit = np.where(can_commit, np.maximum(commit_rel_now, q),
                              commit_rel_now)

        def vote_ok(mask):
            n = mask.sum(axis=1)
            votes = (self.granted & mask).sum(axis=1)
            return (n > 0) & (votes >= n // 2 + 1)

        el = vote_ok(vm)
        in_joint = ovm.any(axis=1)
        if in_joint.any():
            elected_q = np.where(in_joint, el & vote_ok(ovm), el)
        else:
            elected_q = el  # steady state: no joint-config vote count
        # joint consensus: the lease needs BOTH configs responsive
        # (NodeImpl#checkDeadNodes walks conf and oldConf)
        ack64 = np.clip(self.last_ack, _NEG_I32, None).astype(np.int64)
        q_ack = _np_joint_order_stat(ack64, vm, ovm)
        have_ack = q_ack > _NEG_I32
        awake = ~self.quiescent
        return _NpOutputs(
            commit_rel=new_commit,
            commit_advanced=new_commit > commit_rel_now,
            elected=is_candidate & elected_q,
            election_due=(is_follower | is_candidate) & awake
            & (now >= self.elect_deadline),
            # step_down stays LIVE for quiescent leaders: store-lease
            # acks refresh their rows, so a dead store still deposes
            # its hibernating leaders (mirrors ops/tick.py)
            step_down=is_leader & have_ack & (now - q_ack >= self.eto_ms),
            hb_due=is_leader & awake & (now >= self.hb_deadline),
            lease_valid=is_leader & have_ack & (now - q_ack < self.lease_ms),
            snap_due=(self.role != ROLE_INACTIVE) & (self.snap_ms > 0)
            & (now >= self.snap_deadline),
            q_ack=q_ack,
            stepdown_due=is_leader & awake & (now >= self.stepdown_deadline),
            fence_ok=is_leader & (self.fence_start > _NEG_I32) & have_ack
            & (q_ack >= self.fence_start),
        )

    def eager_commit_slot(self, s: int) -> bool:
        """Event-driven commit advancement for ONE slot, on the ack path
        (TickOptions.eager_commit): the scalar mirror of the device
        tick's joint quorum reduce over this slot's [P] match row —
        joint-consensus aware (both quorums while ``old_voter_mask`` is
        populated), gated on the leadership window (``pending_rel``)
        exactly like ops/tick.py's ``can_commit``.  ~O(P log P) per
        ack on one row; the win is that a hot group's quorum closes on
        the ack that completes it instead of waiting out the tick
        pace.  The next tick recomputes the same value and finds
        nothing to advance (``commit_abs`` already moved)."""
        row = self.match_abs[s]

        def order_stat(mask: np.ndarray) -> int:
            vals = np.sort(row[mask])[::-1]
            n = vals.size
            return int(vals[n // 2]) if n else -1

        q = order_stat(self.voter_mask[s])
        if self.old_voter_mask[s].any():
            q = min(q, order_stat(self.old_voter_mask[s]))
        if self._n_witness_slots:
            # witness commit clamp, absolute-index domain (the scalar
            # mirror of the device tick's ballot.witness_commit_clamp)
            wm = self.witness_mask[s]
            voters = self.voter_mask[s] | self.old_voter_mask[s]
            if (voters & wm).any():
                data = voters & ~wm
                q = min(q, int(row[data].max()) if data.any() else 0)
        if q < self.base[s] + self.pending_rel[s] or q <= self.commit_abs[s]:
            return False
        self.commit_abs[s] = q
        self.eager_commits += 1
        box = self._boxes[s]
        if box is not None:
            box._advance(q)
        return True

    def _apply_commits(self, out) -> int:
        advanced = 0
        for s in np.nonzero(np.asarray(out.commit_advanced))[0]:
            box = self._boxes[s]
            if box is None:
                continue
            new_commit = int(self.base[s] + out.commit_rel[s])
            if new_commit > self.commit_abs[s]:
                self.commit_abs[s] = new_commit
                advanced += 1
                box._advance(new_commit)
        self.commit_advances += advanced
        return advanced

    def _apply_protocol(self, out, now: int) -> None:
        """Schedule slow-path handlers from the tick's event masks
        (controlled slots only); handlers re-verify under the node lock."""
        hc = self.has_ctrl
        for s in np.nonzero(np.asarray(out.election_due) & hc)[0]:
            ctrl = self._ctrls[s]
            if ctrl is None:
                continue
            # push the deadline NOW: the handler runs async, and a
            # same-deadline refire every tick until it runs would storm
            ctrl.push_election_deadline(now)
            ctrl.schedule("election_due", ctrl.node._on_election_due)
        for s in np.nonzero(np.asarray(out.elected) & hc)[0]:
            ctrl = self._ctrls[s]
            if ctrl is not None:
                ctrl.schedule("elected", ctrl.node._on_engine_elected)
        for s in np.nonzero(np.asarray(out.step_down) & hc)[0]:
            ctrl = self._ctrls[s]
            if ctrl is not None:
                ctrl.schedule("quorum_dead",
                              ctrl.node._on_engine_quorum_dead)
        for s in np.nonzero(np.asarray(out.stepdown_due) & hc)[0]:
            ctrl = self._ctrls[s]
            if ctrl is None:
                continue
            # re-arm the host mirror NOW (the handler runs async; a
            # same-deadline refire every tick would storm) on the
            # timer-mode cadence: eto/2, the reference stepDownTimer.
            self.stepdown_deadline[s] = now + max(1, int(self.eto_ms[s]) // 2)
            self.stepdown_ticks += 1
            # _check_dead_nodes re-verifies the quorum under the node
            # lock AND accrues priority_transfer_rounds — the exact
            # handler timer-mode runs, so decay-elected engine leaders
            # transfer back with zero node-side special casing
            ctrl.schedule("stepdown_tick", ctrl.node._check_dead_nodes)
        for s in np.nonzero(np.asarray(out.fence_ok) & hc)[0]:
            self._resolve_fences(int(s))
        hb_slots = np.nonzero(np.asarray(out.hb_due) & hc)[0]
        if hb_slots.size:
            self._flush_heartbeats(hb_slots, now)
        snap_slots = np.nonzero(np.asarray(out.snap_due) & hc)[0]
        for s in snap_slots:
            ctrl = self._ctrls[s]
            if ctrl is None:
                continue
            # advance the host mirror NOW (the handler runs async; a
            # same-deadline refire every tick would herd), keeping each
            # group on its own staggered phase
            self.snap_deadline[s] = now + int(self.snap_ms[s])
            ctrl.schedule("snapshot_due", ctrl.node._on_snapshot_due)

    def _flush_heartbeats(self, slots, now: int) -> None:
        """Batched heartbeat fan-out for all due leader groups: ONE
        HeartbeatHub.pulse per hub covering every due group this tick
        (the send-matrix plane — O(endpoints) RPCs, not O(groups))."""
        by_hub: dict[int, tuple[object, list]] = {}
        direct: list = []
        # phase-align each next beat to its group's hb_ms grid: groups
        # sharing an interval then fall due on the SAME tick, so one
        # pulse per interval carries every such group's beat (max hub
        # batching — staggered per-group beats degrade to ~1 per RPC).
        # Mirrors the device's deadline advance so masks don't refire.
        hbs = self.hb_ms[slots]
        self.hb_deadline[slots] = (now // hbs + 1) * hbs
        for s in slots:
            ctrl = self._ctrls[s]
            if ctrl is None:
                continue
            node = ctrl.node
            if not node.is_leader():
                continue
            # quiescence bookkeeping: count consecutive fully-acked idle
            # rounds; at the threshold the round's beats carry the
            # quiesce handshake (every follower must ack before the
            # group hibernates — see EngineControl.maybe_quiesce)
            ctrl.maybe_quiesce(now)
            if self.quiescent[s]:
                continue  # hibernated (e.g. single-voter: no handshake)
            reps = node.replicators.all()
            if not reps:
                continue
            nm = node.node_manager
            opt = node.options.raft_options.coalesce_heartbeats
            if nm is None or opt is False:
                direct.extend(reps)
                continue
            # AUTO (None): coalesce per peer once its responses advertise
            # multi_heartbeat — idle beats become O(endpoints) by default
            hub = nm.heartbeat_hub
            for r in reps:
                if opt is True or r.peer_multi_hb:
                    by_hub.setdefault(id(hub), (hub, []))[1].append(r)
                else:
                    direct.append(r)
        for hub, reps in by_hub.values():
            hub.pulse(reps)
        for r in direct:
            t = asyncio.ensure_future(r.send_heartbeat())
            t.add_done_callback(
                lambda tt: tt.cancelled() or tt.exception())


def _np_order_stat(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-row q-th largest among masked slots (q = n//2 + 1), NEG for
    empty masks — the numpy oracle of ops.ballot.quorum_match_index."""
    NEG = np.int64(_NEG_I32)
    v = np.where(mask, values, NEG)
    sd = -np.sort(-v, axis=1)
    n = mask.sum(axis=1)
    qi = np.clip(n // 2, 0, values.shape[1] - 1)
    picked = np.take_along_axis(sd, qi[:, None], axis=1)[:, 0]
    return np.where(n > 0, picked, NEG)


def _np_joint_order_stat(values: np.ndarray, vm: np.ndarray,
                         ovm: np.ndarray) -> np.ndarray:
    """Joint-consensus order statistic: min of both configs' q-th
    largest where a row is in joint mode — the shared shape of
    ballot.joint_quorum_match_index AND joint_quorum_ack_time."""
    new_q = _np_order_stat(values, vm)
    joint = ovm.any(axis=1)
    if not joint.any():
        # no group is mid membership-change (the steady state): skip
        # the old-config order statistic entirely — it is half the
        # tick's sort work (profiled: 4 sorts/tick -> 2)
        return new_q
    old_q = _np_order_stat(values, ovm)
    return np.where(joint, np.minimum(new_q, old_q), new_q)


def _np_joint_quorum(rel: np.ndarray, vm: np.ndarray, ovm: np.ndarray
                     ) -> np.ndarray:
    return _np_joint_order_stat(rel.astype(np.int64), vm, ovm
                                ).astype(np.int32)
