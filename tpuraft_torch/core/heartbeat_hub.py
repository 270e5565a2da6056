"""HeartbeatHub: coalesce leader heartbeats across raft groups.

TPU-native multi-raft scaling piece (SURVEY.md §3.5 "batched per-tick
(group, peer) send matrices"; no reference counterpart — the reference
sends one heartbeat RPC per (group, follower) pair).  With thousands of
groups multiplexed on one endpoint, per-group heartbeats cost
O(G x P) RPCs per interval even when idle.  The hub sends ONE
``multi_heartbeat`` RPC per destination endpoint per tick, packing the
empty-AppendEntries beat of every local leader group replicating to
that endpoint; the receiving NodeManager fans the beats out to its
local nodes and returns the acks batched the same way.

Correctness notes:
- Each beat is a full AppendEntriesRequest and each ack a full
  AppendEntriesResponse, processed by the SAME per-replicator logic as
  the direct path (lease acks, step-down on higher term, re-probe on
  lost match) — only the transport envelope is shared.
- A transport failure produces no acks, so leader-lease dead-node
  detection (Node._check_dead_nodes) behaves exactly as with per-group
  heartbeats.
- The ReadIndex (SAFE) quorum round keeps its direct per-group
  heartbeats: its latency is user-facing and must not wait for the next
  hub tick.

Opt in with ``RaftOptions.coalesce_heartbeats = True`` (the node must
be wired to a NodeManager, which owns the hub).

Two drivers share :meth:`pulse`:
- TIMER mode (nodes without an engine): the hub's own clock beats all
  registered replicators each interval.
- ENGINE mode: replicators never register a clock; the device tick's
  ``hb_due`` mask collects every due group and calls ``pulse`` once per
  tick (``MultiRaftEngine._flush_heartbeats``), with deadlines
  phase-aligned to the hb interval so beats batch maximally.

Operating envelope (timer mode): the hub is one shared clock per
process, so a late loop wakeup delays EVERY group's beat at once — a
correlation that independent per-group timers don't have.  TIMER MODE
IS THE LEGACY/SMALL-DEPLOYMENT PATH: at density, run the engine control
plane — the device tick's masks schedule beats with no per-group
timers, the engine now derives election-timeout floors from registered
group count + measured tick cost (TickOptions.density_aware_timeouts),
and idle groups hibernate entirely (RaftOptions.quiesce_after_rounds),
collapsing idle beat traffic to the store-level lease below.  The
timer-mode hub still beats at HALF the per-group heartbeat interval
for margin, and timer-mode nodes neither quiesce nor get derived
floors — size their timeouts by docs/operations.md "Density tuning &
quiescence".

Store-level liveness lease (quiescence): while any LOCAL leader group
is hibernating toward an endpoint, the hub sends ONE tiny
``store_lease`` beat per endpoint pair per interval — O(stores^2)
idle RPCs regardless of group count, and pair-deduped on top: a beat
proves the sender alive and its ack proves the receiver alive, so the
higher endpoint of each pair suppresses its own sender while the
lower's beats flow with margin (``lease_suppressed`` counter), roughly
halving even that.  Receiver side, the hub re-arms the sender's lease
(and credits the beat to its own quiescent leaders toward that store,
as an ack would) and a watcher task wakes every dependent quiescent
group (randomized election timeouts) the moment a lease expires;
sender side, each ack refreshes the engine rows of the quiescent
leader groups behind it and re-arms the acking store's lease, keeping
dead-quorum step-down and leader-lease reads live for hibernating
groups.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

from tpuraft_torch.util import clock as clockmod

from tpuraft_torch.rpc.messages import (
    BatchRequest,
    CompactBeat,
    MultiHeartbeatRequest,
    MultiHeartbeatResponse,
    StoreLeaseBeat,
    decode_message,
    encode_message,
)
from tpuraft_torch.rpc.transport import RpcError, is_no_method

if TYPE_CHECKING:
    from tpuraft_torch.core.replicator import Replicator

LOG = logging.getLogger(__name__)


# graftcheck: loop-confined — one hub per NodeManager, driven by its
# loop's clock task / engine tick; counters and lease maps are lockless
class HeartbeatHub:
    def __init__(self, clock=None) -> None:
        # injectable time plane (ISSUE 18): ALL lease bookkeeping below
        # runs on the store's clock so a per-store clock fault skews
        # sender- and receiver-side lease math coherently
        self.clock = clockmod.resolve(clock)
        # worst-case inter-store clock rate error rho (RaftOptions.
        # clock_drift_bound, threaded by StoreEngine): every lease
        # duration granted BY another store's clock but timed on OURS is
        # shrunk by (1 - rho) — zero-margin legacy accounting at 0.0
        self.clock_drift_bound = 0.0
        # peer-skew estimator (ClockSentinel) fed by every beat ack that
        # carries the responder's clock reading; None = no detection
        self.clock_sentinel = None
        # (id(replicator)) -> replicator; grouped by endpoint per tick so
        # registration order never matters
        self._members: dict[int, "Replicator"] = {}
        self._task: Optional[asyncio.Task] = None
        self._inflight: dict[str, asyncio.Task] = {}  # dst -> send task
        self._interval_s = 0.1
        # chunking bound: enough to collapse idle RPC load by an order of
        # magnitude, small enough that a contended group's slow ack only
        # delays its own chunk
        self.max_beats_per_rpc = 16
        # fast beats are data rows, not frames: a straggler answers
        # needs_full instead of delaying its chunk, so chunks can be big
        self.max_fast_beats_per_rpc = 1024
        self.rpcs_sent = 0      # multi_heartbeat RPCs (observability)
        self.beats_sent = 0     # individual group beats carried
        self.fast_beats_sent = 0
        self.fast_fallbacks = 0
        # -- load-adaptive cadence widening ---------------------------------
        # at density (1024 groups x 3 replicas) the hub builds ~2000 beat
        # rows/s of pure standing load; when a pulse carries many rows the
        # hub stretches its sleep toward load_widen_max x the base interval.
        # The base interval is eto/factor/2 (register() above), so the cap
        # of 2.0 only relaxes cadence back to the classic per-group
        # heartbeat interval — still half the election timeout, still safe.
        self.load_widen_rows = 512   # rows/pulse that saturate the widening
        self.load_widen_max = 2.0
        self._widen = 1.0            # EMA'd widening factor (>= 1.0)
        self.widened_pulses = 0      # pulses sent while meaningfully widened
        self._fast_ok: dict[str, bool] = {}  # dst lacks multi_beat_fast
        # -- store-level liveness lease (quiescence) -------------------------
        # sender: dst endpoint -> {id(engine): [engine, transport,
        # src_endpoint, refcount, min_eto_ms]} — one lease beat per dst
        # per interval while any local leader group hibernates toward it
        self._lease_targets: dict[str, dict[int, list]] = {}
        self._lease_task: Optional[asyncio.Task] = None
        # sender: dst -> monotonic time of the last successful lease ack
        # (store_lease_quorum_ok consults this for hibernating leaders)
        # — ALSO refreshed by an incoming beat from dst: a store that
        # beats us is just as provably alive as one that acks us, which
        # is what lets the pair-dedupe below halve idle lease traffic
        self._lease_ack_at: dict[str, float] = {}
        # receiver: src endpoint -> monotonic lease expiry deadline
        self._lease_from: dict[str, float] = {}
        # receiver: src endpoint -> set of EngineControls to wake on expiry
        self._lease_deps: dict[str, set] = {}
        self._lease_watch_task: Optional[asyncio.Task] = None
        # nudges the watcher out of its sleep-to-horizon when a NEW
        # dependency may carry an earlier deadline (so the watcher can
        # sleep until the actual next expiry — minutes at derived
        # timeouts — instead of polling at a fixed sub-second cadence)
        self._lease_watch_nudge = asyncio.Event()
        # lease/quiescence counters (surfaced via describe + soak stats)
        self.lease_rpcs_sent = 0
        self.lease_acks = 0
        self.lease_beats_seen = 0   # receiver side
        self.lease_expiries = 0
        self.lease_suppressed = 0   # pair-dedupe: rounds we rode the
        # peer's beats instead of sending our own
        self.groups_quiesced = 0
        self.groups_woken = 0
        # gray-failure signal sink: the hosting store's HealthTracker
        # (set by StoreEngine).  Every beat RPC the hub already sends
        # doubles as a per-endpoint RTT probe — no extra traffic.
        self.health = None
        from tpuraft_torch.util import describer
        from tpuraft_torch.util.metrics import MetricRegistry

        # one registry per hub, gauges bound to the live counters — the
        # beat-plane sibling of Node.metrics (util/metrics.py idiom);
        # snapshot() is what the soak stats line and benches read
        self.metrics = MetricRegistry()
        for name in ("rpcs_sent", "beats_sent", "fast_beats_sent",
                     "fast_fallbacks", "groups_quiesced", "groups_woken",
                     "lease_rpcs_sent", "lease_acks", "lease_beats_seen",
                     "lease_expiries", "lease_suppressed", "widened_pulses"):
            self.metrics.gauge(f"hub.{name}",
                               lambda n=name: getattr(self, n))
        self.metrics.gauge("hub.widen_factor", lambda: self._widen)
        describer.register(self)

    def register(self, replicator: "Replicator") -> None:
        node = replicator._node
        # beat at HALF the per-group heartbeat interval: the hub is one
        # shared clock, so a late wakeup delays every group's beat at
        # once — the margin keeps late beats inside election timeouts
        interval = (node.options.election_timeout_ms
                    / node.options.raft_options.election_heartbeat_factor
                    / 1000.0) / 2
        self._interval_s = min(self._interval_s, interval) \
            if self._members else interval
        self._members[id(replicator)] = replicator
        if self._task is None:
            self._task = asyncio.ensure_future(self._loop())

    def deregister(self, replicator: "Replicator") -> None:
        self._members.pop(id(replicator), None)
        if not self._members and self._task is not None:
            # nothing to beat: stop the loop (register() restarts it) so
            # cluster teardown leaves no dangling task
            self._task.cancel()
            self._task = None
            for t in self._inflight.values():
                t.cancel()
            self._inflight.clear()

    async def shutdown(self) -> None:
        self._members.clear()
        self._lease_targets.clear()
        self._lease_deps.clear()
        for task in (self._task, self._lease_task, self._lease_watch_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._task = self._lease_task = self._lease_watch_task = None
        from tpuraft_torch.util import describer

        describer.unregister(self)

    def describe(self) -> str:
        """Hub counters for operators (registered with util.describer —
        the beat-plane counterpart of Node#describe)."""
        return (f"HeartbeatHub<members={len(self._members)} "
                f"rpcs_sent={self.rpcs_sent} beats_sent={self.beats_sent} "
                f"fast_beats_sent={self.fast_beats_sent} "
                f"fast_fallbacks={self.fast_fallbacks} "
                f"quiesced={self.groups_quiesced} woken={self.groups_woken} "
                f"lease_rpcs={self.lease_rpcs_sent} "
                f"lease_acks={self.lease_acks} "
                f"lease_beats_seen={self.lease_beats_seen} "
                f"lease_expiries={self.lease_expiries} "
                f"lease_suppressed={self.lease_suppressed} "
                f"lease_targets={len(self._lease_targets)} "
                f"lease_deps={sum(map(len, self._lease_deps.values()))} "
                f"widen={self._widen:.2f} "
                f"widened_pulses={self.widened_pulses}>")

    def counters(self) -> dict:
        """Counter snapshot (soak stats line / tests)."""
        return {
            "rpcs_sent": self.rpcs_sent,
            "beats_sent": self.beats_sent,
            "fast_beats_sent": self.fast_beats_sent,
            "fast_fallbacks": self.fast_fallbacks,
            "groups_quiesced": self.groups_quiesced,
            "groups_woken": self.groups_woken,
            "lease_rpcs_sent": self.lease_rpcs_sent,
            "lease_acks": self.lease_acks,
            "lease_beats_seen": self.lease_beats_seen,
            "lease_expiries": self.lease_expiries,
            "lease_suppressed": self.lease_suppressed,
            "widened_pulses": self.widened_pulses,
        }

    # -- store-level liveness lease (sender side) ----------------------------

    def lease_add(self, dst: str, engine, transport, src_endpoint: str,
                  eto_ms: int) -> None:
        """A local leader group hibernated toward ``dst``: keep its
        store's liveness proven by one lease beat per interval."""
        entries = self._lease_targets.setdefault(dst, {})
        ent = entries.get(id(engine))
        if ent is None:
            entries[id(engine)] = [engine, transport, src_endpoint, 1,
                                   eto_ms]
        else:
            ent[3] += 1
            ent[4] = min(ent[4], eto_ms)
        if self._lease_task is None or self._lease_task.done():
            self._lease_task = asyncio.ensure_future(self._lease_loop())

    def lease_remove(self, dst: str, engine) -> None:
        entries = self._lease_targets.get(dst)
        if entries is None:
            return
        ent = entries.get(id(engine))
        if ent is None:
            return
        ent[3] -= 1
        if ent[3] <= 0:
            del entries[id(engine)]
        if not entries:
            del self._lease_targets[dst]

    def lease_ack_fresh(self, dst: str, within_ms: int) -> bool:
        """Sender-side store-lease freshness: the window shrinks by the
        drift bound — ``within_ms`` is what the RECEIVER grants on ITS
        clock, and ours may run up to rho slow, so trusting the full
        window would let our 'fresh' outlive the receiver's grant (the
        heartbeat_hub.py:283-vs-379 zero-margin hole, ISSUE 18)."""
        at = self._lease_ack_at.get(dst)
        if at is None:
            return False
        within_ms *= (1.0 - self.clock_drift_bound)
        return (self.clock.monotonic() - at) * 1000 < within_ms

    def _note_peer_clock(self, dst: str, ack, t0: float, now: float) -> None:
        """Feed the skew estimator from an ack's piggybacked clock
        reading (BeatAck/StoreLeaseAck ``clock_ms``, 0 = old peer)."""
        sentinel = self.clock_sentinel
        if sentinel is None:
            return
        clock_ms = getattr(ack, "clock_ms", 0)
        if clock_ms:
            sentinel.observe(dst, clock_ms / 1000.0, t0, now)

    async def _lease_loop(self) -> None:
        """ONE store_lease RPC per dst endpoint per interval — the whole
        idle cost of a hibernated deployment.  Interval = min dependent
        eto / 4, so a silent store misses ~4 beats before its lease
        expires — inside the normal fault-detection envelope."""
        try:
            while self._lease_targets:
                min_eto = min(ent[4] for entries in
                              self._lease_targets.values()
                              for ent in entries.values())
                await asyncio.sleep(max(0.02, min_eto / 4000.0))
                for dst, entries in list(self._lease_targets.items()):
                    ents = list(entries.values())
                    if not ents:
                        continue
                    # pair dedupe: a lease beat is a BIDIRECTIONAL
                    # liveness proof (the beat proves the sender alive,
                    # its ack proves the receiver alive), so only one
                    # side of each endpoint pair needs to send.  The
                    # higher endpoint rides the lower's beats while they
                    # flow with margin to spare, and resumes its own the
                    # moment they thin out (peer died, or stopped having
                    # leaders toward us) — the fault-detection envelope
                    # is unchanged, the idle RPC rate halves.
                    if ents[0][2] > dst:
                        margin = (self._lease_from.get(dst, 0.0)
                                  - self.clock.monotonic())
                        if margin > min(e[4] for e in ents) / 2000.0:
                            self.lease_suppressed += 1
                            continue
                    t = asyncio.ensure_future(self._lease_beat(dst, ents))
                    t.add_done_callback(
                        lambda tt: tt.cancelled() or tt.exception())
                # lease rounds drive the (otherwise fully idle) engines'
                # ticks, so quiescent-leader step_down staleness is
                # re-evaluated at lease cadence even with zero traffic
                seen = set()
                for entries in self._lease_targets.values():
                    for ent in entries.values():
                        if id(ent[0]) not in seen:
                            seen.add(id(ent[0]))
                            ent[0].mark_dirty()
        except asyncio.CancelledError:
            return
        finally:
            self._lease_task = None

    async def _lease_beat(self, dst: str, ents: list) -> None:
        engine_list = [ent[0] for ent in ents]
        transport = ents[0][1]
        src = ents[0][2]
        lease_ms = min(ent[4] for ent in ents)
        self.lease_rpcs_sent += 1
        t0 = self.clock.monotonic()
        try:
            ack = await transport.call(
                dst, "store_lease",
                StoreLeaseBeat(endpoint=src, lease_ms=lease_ms),
                timeout_ms=max(1, lease_ms // 2))
        except RpcError:
            return  # silence: rows go stale -> step_down, as designed
        self.lease_acks += 1
        now = self.clock.monotonic()
        self._note_peer_clock(dst, ack, t0, now)
        self._lease_ack_at[dst] = now
        for engine in engine_list:
            engine.note_store_ack(dst)
        # the ack also proves dst alive for OUR quiescent followers
        # (pair dedupe: dst may be riding these beats instead of
        # sending its own, so this re-arm is their only refresh) —
        # drift-padded like note_lease_from: the duration is granted on
        # OUR clock here but consumed against dst's liveness, and the
        # symmetric pad keeps both arming paths identical
        deadline = now + lease_ms / 1000.0 * (1.0 - self.clock_drift_bound)
        if deadline > self._lease_from.get(dst, 0.0):
            self._lease_from[dst] = deadline

    # -- store-level liveness lease (receiver side) --------------------------

    def note_lease_from(self, src: str, lease_ms: int) -> int:
        """An incoming store_lease beat: re-arm ``src``'s lease.
        Returns the dependent count (ack observability)."""
        self.lease_beats_seen += 1
        now = self.clock.monotonic()
        # receiver-side drift pad (ISSUE 18 satellite): ``lease_ms`` is
        # a duration granted on the SENDER's clock but timed out on
        # ours — if ours runs up to rho slow, the unpadded deadline
        # silently extends the lease past the sender's intent, so the
        # receiver honors only (1 - rho) of the grant
        deadline = now + lease_ms / 1000.0 * (1.0 - self.clock_drift_bound)
        if deadline > self._lease_from.get(src, 0.0):
            self._lease_from[src] = deadline
        # the beat also proves src alive for OUR quiescent leaders
        # toward it — exactly what an ack of our own beat would prove
        # (pair dedupe: while src keeps beating us, our sender skips
        # its half of the pair and this is the leaders' only refresh)
        entries = self._lease_targets.get(src)
        if entries:
            self._lease_ack_at[src] = now
            for ent in list(entries.values()):
                ent[0].note_store_ack(src)
        return len(self._lease_deps.get(src, ()))

    def lease_fresh(self, src: str) -> bool:
        return self._lease_from.get(src, 0.0) > self.clock.monotonic()

    def lease_depend(self, src: str, ctrl, lease_ms: int) -> None:
        """A local quiescent follower group delegates liveness of its
        leader's store to this lease.  Registration arms the lease (the
        quiesce beat itself just proved the store alive)."""
        self._lease_deps.setdefault(src, set()).add(ctrl)
        self.note_lease_from(src, lease_ms)
        self.lease_beats_seen -= 1  # registration is not a beat
        self._lease_watch_nudge.set()  # new dep may have an earlier
        # deadline than the watcher's current sleep-to-horizon
        if self._lease_watch_task is None or self._lease_watch_task.done():
            self._lease_watch_task = asyncio.ensure_future(
                self._lease_watch())

    def lease_undepend(self, src: str, ctrl) -> None:
        deps = self._lease_deps.get(src)
        if deps is None:
            return
        deps.discard(ctrl)
        if not deps:
            del self._lease_deps[src]

    async def _lease_watch(self) -> None:
        """Wake EXACTLY the groups depending on an expired store lease,
        each with a randomized election timeout (no thundering herd).
        Sleeps until the earliest expiry (deadlines only ever extend;
        lease_depend nudges us when a new dependency might be earlier)
        — a fully-hibernated process takes no standing sub-second
        wakeups from the watcher."""
        try:
            while self._lease_deps:
                horizon = min(self._lease_from.get(src, 0.0)
                              for src in self._lease_deps)
                wait = max(0.02, horizon - self.clock.monotonic())
                self._lease_watch_nudge.clear()
                try:
                    await asyncio.wait_for(
                        self._lease_watch_nudge.wait(), wait)
                except asyncio.TimeoutError:
                    pass
                now = self.clock.monotonic()
                for src in [s for s in list(self._lease_deps)
                            if self._lease_from.get(s, 0.0) <= now]:
                    ctrls = self._lease_deps.pop(src, set())
                    self.lease_expiries += 1
                    LOG.info("store lease from %s expired: waking %d "
                             "quiescent groups", src, len(ctrls))
                    for ctrl in ctrls:
                        try:
                            ctrl.wake_for_lease_expiry()
                        except Exception:  # noqa: BLE001 — one group's
                            LOG.exception("lease-expiry wake failed")
        except asyncio.CancelledError:
            return
        finally:
            self._lease_watch_task = None

    async def _loop(self) -> None:
        try:
            while True:
                # widened sleep: load_widen_max caps at the classic
                # per-group cadence (see ctor), so stretching under row
                # load never risks follower election timeouts
                await asyncio.sleep(self._interval_s * self._widen)
                await self.tick_once()
        except asyncio.CancelledError:
            return

    async def tick_once(self) -> None:
        self.pulse(list(self._members.values()))

    def pulse(self, replicators: list["Replicator"]) -> None:
        """Beat the given replicators NOW, batched per destination
        endpoint.  Two callers: the hub's own clock (tick_once) and the
        engine's hb_due mask (MultiRaftEngine._flush_heartbeats), which
        passes every due group's replicators in one call so idle beats
        stay O(endpoints) per tick.

        Steady-state beats ride the beat-plane FAST path (CompactBeat
        data, inline lock-free validation on the receiver — see
        NodeManager._handle_multi_beat_fast): at region density the
        classic per-beat handler fan-out is the dominant idle CPU burn.
        A group whose fast beat answers needs-full (term moved,
        committed behind, follower restarted) gets a classic
        full-semantics beat as the follow-up; replicators not yet
        matched, or whose endpoint hasn't advertised the capability,
        take the classic path directly.

        Frames/beats MUST be built here, synchronously: between the
        is_leader() check and an await, a step-down + re-election can
        change the node's term, and a beat built late would claim
        leadership of the NEW term from a node that is now a follower
        (observed as spurious "two leaders in one term" conflicts on
        receivers).  No awaits may separate the check from the build."""
        by_dst_fast: dict[str, list[tuple["Replicator", CompactBeat]]] = {}
        classic: list["Replicator"] = []
        for r in replicators:
            node = r._node
            if not node.is_leader() or not r._running:
                continue
            quiesce_ms = getattr(r, "_quiesce_lease_ms", 0)
            if quiesce_ms:
                r._quiesce_lease_ms = 0
            if (r.peer_multi_hb and r._matched
                    and self._fast_ok.get(r.peer.endpoint, True)):
                committed = min(node.ballot_box.last_committed_index,
                                r.match_index)
                # idle-burn dominator at region density: reuse the beat
                # object while (term, committed) are unchanged — the
                # steady state — instead of rebuilding it every pulse
                cached = getattr(r, "_fast_beat_cache", None)
                if quiesce_ms:
                    # quiesce handshake rides its own (uncached) beat
                    beat = CompactBeat(
                        group_id=node.group_id,
                        server_id=str(node.server_id),
                        peer_id=str(r.peer),
                        term=node.current_term,
                        committed_index=committed,
                        quiesce=True, lease_ms=quiesce_ms)
                elif (cached is not None
                        and cached.term == node.current_term
                        and cached.committed_index == committed):
                    beat = cached
                else:
                    beat = CompactBeat(
                        group_id=node.group_id,
                        server_id=str(node.server_id),
                        peer_id=str(r.peer),
                        term=node.current_term,
                        committed_index=committed)
                    r._fast_beat_cache = beat
                by_dst_fast.setdefault(r.peer.endpoint, []).append((r, beat))
                continue
            if quiesce_ms:
                # the handshake needs the fast path; a classic-only peer
                # cannot carry it — the group just stays active
                ctrl = getattr(node, "_ctrl", None)
                if ctrl is not None and hasattr(ctrl, "abort_quiesce"):
                    ctrl.abort_quiesce()
            classic.append(r)
        # fold this pulse's row count into the cadence-widening EMA: a
        # hub carrying load_widen_rows+ rows per pulse converges on
        # load_widen_max x its base interval (timer-mode standing-load
        # relief at region density); an idling hub decays back to 1.0
        rows = sum(map(len, by_dst_fast.values())) + len(classic)
        target = 1.0 + (min(1.0, rows / self.load_widen_rows)
                        * (self.load_widen_max - 1.0))
        self._widen += 0.25 * (target - self._widen)
        if self._widen > 1.05:
            self.widened_pulses += 1
        for dst, pairs in by_dst_fast.items():
            for ci in range(0, len(pairs), self.max_fast_beats_per_rpc):
                chunk = pairs[ci:ci + self.max_fast_beats_per_rpc]
                key = f"fast:{dst}#{ci // self.max_fast_beats_per_rpc}"
                if key in self._inflight:
                    continue
                t = asyncio.ensure_future(self._beat_fast(dst, chunk))
                self._inflight[key] = t
                reps = [r for r, _ in chunk]
                t.add_done_callback(
                    lambda _t, k=key, rs=reps: self._reap(k, _t, rs))
        if classic:
            self._pulse_classic(classic)

    def _reap(self, key: str, t: asyncio.Task,
              fallback: Optional[list["Replicator"]] = None) -> None:
        """Done-callback for beat tasks: always retrieve the exception
        (an unretrieved one is event-loop log spam AND a silently
        missed beat), and give fast-path chunks that died on an
        unexpected error their classic-beat fallback so a persistent
        non-RpcError (e.g. codec failure) can't starve those groups of
        heartbeats until their followers start elections."""
        self._inflight.pop(key, None)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is None:
            return
        LOG.warning("heartbeat batch %s failed: %r", key, exc)
        if fallback:
            self._abort_quiesce(fallback)
            self.fast_fallbacks += len(fallback)
            self._pulse_classic([r for r in fallback if r._running])

    def _dispatch_classic(
            self, by_dst: dict[str, list[tuple["Replicator", bytes]]]
    ) -> None:
        # fire-and-track per destination chunk: the tick cadence must NOT
        # wait for RPC round trips (a slow endpoint would stall
        # heartbeats to every other endpoint and trigger elections
        # everywhere), and batches are capped so one contended group's
        # slow ack only couples the fates of its own chunk, not every
        # group on the endpoint pair.  A chunk whose previous RPC is
        # still in flight is skipped this tick.
        for dst, pairs in by_dst.items():
            for ci in range(0, len(pairs), self.max_beats_per_rpc):
                chunk = pairs[ci:ci + self.max_beats_per_rpc]
                key = f"{dst}#{ci // self.max_beats_per_rpc}"
                if key in self._inflight:
                    continue
                t = asyncio.ensure_future(self._beat_endpoint(dst, chunk))
                self._inflight[key] = t
                t.add_done_callback(
                    lambda _t, k=key: self._reap(k, _t))

    @staticmethod
    def _abort_quiesce(reps: list["Replicator"]) -> None:
        """A chunk carrying quiesce-handshake beats failed (RPC error,
        short response, classic fallback): the affected groups stay
        active — a hibernation the followers may not have joined is a
        safety hole, an aborted one just costs beats."""
        for r in reps:
            ctrl = getattr(r._node, "_ctrl", None)
            if ctrl is not None and hasattr(ctrl, "abort_quiesce"):
                ctrl.abort_quiesce()

    async def _beat_fast(self, dst: str,
                         pairs: list[tuple["Replicator", object]]) -> None:
        reps = [r for r, _ in pairs]
        items = [b for _, b in pairs]
        quiescing = [r for r, b in pairs if getattr(b, "quiesce", False)]
        node = reps[0]._node
        self.rpcs_sent += 1
        self.fast_beats_sent += len(items)
        t0 = self.clock.monotonic()
        try:
            resp = await node.transport.call(
                dst, "multi_beat_fast", BatchRequest(items=items),
                timeout_ms=node.options.election_timeout_ms // 2 or 1)
        except RpcError as e:
            self._abort_quiesce(quiescing)
            if is_no_method(e):
                # receiver predates the beat plane: classic beats only
                self._fast_ok[dst] = False
                self.fast_fallbacks += len(reps)
                self.pulse(reps)
            return  # else: silence — dead-node detection, as direct
        if self.health is not None:
            self.health.note_peer_rtt(dst, self.clock.monotonic() - t0)
        if len(resp.items) != len(items):
            # short/overlong response: zip would silently drop trailing
            # replicators' acks — treat the whole chunk as deviating
            LOG.warning("multi_beat_fast %s: %d acks for %d beats",
                        dst, len(resp.items), len(items))
            self._abort_quiesce(quiescing)
            self.fast_fallbacks += len(reps)
            self._pulse_classic(reps)
            return
        now = self.clock.monotonic()
        if resp.items:
            self._note_peer_clock(dst, resp.items[0], t0, now)
        fallback: list["Replicator"] = []
        for (r, beat), ack in zip(pairs, resp.items):
            if not r._running or not r._node.is_leader():
                continue
            proposed = getattr(beat, "quiesce", False)
            if getattr(ack, "ok", False):
                # inline ack bookkeeping: the lease plane only needs the
                # (peer, when) write — no per-ack task, no node lock
                r.last_rpc_ack = now
                r._node.on_peer_ack(r.peer, now)
                if proposed:
                    ctrl = getattr(r._node, "_ctrl", None)
                    if ctrl is not None and \
                            hasattr(ctrl, "note_quiesce_ack"):
                        ctrl.note_quiesce_ack(r.peer)
            else:
                if proposed:
                    self._abort_quiesce([r])
                fallback.append(r)
        if fallback:
            # full-semantics follow-up for just the deviating groups
            # (term moved / committed behind / follower restarted)
            self.fast_fallbacks += len(fallback)
            self._pulse_classic(fallback)

    def _pulse_classic(self, replicators: list["Replicator"]) -> None:
        """Classic framed beats only (no fast-path retry) — used for
        fast-beat fallbacks to avoid ping-ponging."""
        by_dst: dict[str, list[tuple["Replicator", bytes]]] = {}
        for r in replicators:
            node = r._node
            if not node.is_leader() or not r._running:
                continue
            frame = encode_message(r.build_heartbeat_request())
            by_dst.setdefault(r.peer.endpoint, []).append((r, frame))
        self._dispatch_classic(by_dst)

    async def _beat_endpoint(self, dst: str,
                             pairs: list[tuple["Replicator", bytes]]
                             ) -> None:
        reps = [r for r, _ in pairs]
        frames = [f for _, f in pairs]
        # any member's transport works; they share the process endpoint
        node = reps[0]._node
        self.rpcs_sent += 1
        self.beats_sent += len(frames)
        t0 = self.clock.monotonic()
        try:
            # half-election-timeout budget, like the direct heartbeat
            # path: with the inflight-chunk skip, a lost request must
            # release its chunk quickly or one dropped packet silences
            # up to max_beats_per_rpc groups for a full timeout
            resp: MultiHeartbeatResponse = await node.transport.call(
                dst, "multi_heartbeat",
                MultiHeartbeatRequest(beats=frames),
                timeout_ms=node.options.election_timeout_ms // 2 or 1)
        except RpcError:
            return  # no acks: dead-node detection sees silence, as direct
        if self.health is not None:
            self.health.note_peer_rtt(dst, self.clock.monotonic() - t0)
        if len(resp.acks) != len(frames):
            # a short ack list must read as silence for the WHOLE chunk
            # (dead-node detection semantics), not as acks for whichever
            # prefix zip happens to pair up
            LOG.warning("multi_heartbeat %s: %d acks for %d beats",
                        dst, len(resp.acks), len(frames))
            return
        for r, blob in zip(reps, resp.acks):
            try:
                ack = decode_message(blob)
            except Exception:  # noqa: BLE001 — malformed single ack
                continue
            if not hasattr(ack, "success"):
                continue  # ErrorResponse: that group was unserviceable
            if r._running and r._node.is_leader():
                await r.process_heartbeat_response(ack)
