"""Replicator: per-(group, follower) log-shipping state machine.

Reference parity: ``core:core/Replicator`` + ``ReplicatorGroupImpl``
(SURVEY.md §3.1 north-star hot path, §4.2): probe → batched
AppendEntries → matchIndex advance → BallotBox#commitAt; separate
heartbeat cadence; InstallSnapshot fallback when the follower is behind
the compacted log; TimeoutNow for leadership transfer.

Round-4 redesign (SURVEY §3.5 "batched per-tick (group, peer) send
matrices", §8.2 "send-plans"): the replicator is a PASSIVE state
machine — no standing task, no per-RPC task, no log-manager waiter.
Events (log appends via :meth:`wake`, batch responses, engine masks)
drive :meth:`pump`, which builds up to a window of AppendEntries and
hands them to the shared per-endpoint :class:`~tpuraft.core.send_plane.
EndpointSender`; the whole window rides ONE ``multi_append`` RPC
together with every other group on the endpoint pair.  Standing tasks
per process drop from O(groups x peers) (the reference's
thread-per-replicator shape, and this file's own pre-r4 ``_run`` task)
to O(endpoints).

Pipelining (reference: inflight FIFO, ``maxReplicatorInflightMsgs``):
up to ``RaftOptions.max_inflight_msgs`` AppendEntries ride per batch,
resolved strictly in send order (the sender preserves order, the
receiver executes a node's items sequentially) — single-group
throughput is window x batch per endpoint round trip.  A head failure
rolls the window back to the confirmed ``match_index`` and re-probes,
exactly like the old FIFO.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from tpuraft_torch.entity import PeerId, strip_entry_payload
from tpuraft_torch.errors import RaftError
from tpuraft_torch.rpc.messages import (
    AppendEntriesRequest,
    ErrorResponse,
    TimeoutNowRequest,
)
from tpuraft_torch.rpc.transport import RpcError
from tpuraft_torch.util.trace import TRACER as _TRACE
from tpuraft_torch.util.trace import entry_ctx as trace_entry_ctx

LOG = logging.getLogger(__name__)


def _consume(t: "asyncio.Task") -> None:
    if not t.cancelled():
        t.exception()


# graftcheck: loop-confined — no lock: every field below is touched only
# on the owning node's event loop (wake/pump/response tasks)
class Replicator:
    def __init__(self, node, peer: PeerId):
        self._node = node
        self.peer = peer
        # ack stamps share the NODE's clock: quorum_ack_age_s compares
        # them against the same (possibly injected) timeline
        self._clock = node._clock
        self.next_index = node.log_manager.last_log_index() + 1
        self.match_index = 0
        self._matched = False  # True after the first successful probe/append
        self.last_rpc_ack = self._clock.monotonic()
        self._running = False
        self._hub = None  # HeartbeatHub when coalescing is enabled
        self._hb_task: Optional[asyncio.Task] = None
        # does the peer's endpoint serve multi_heartbeat?  Learned from
        # every AppendEntries response (probe/ack/beat); drives AUTO
        # coalescing (RaftOptions.coalesce_heartbeats=None)
        self.peer_multi_hb = False
        # quiesce handshake: EngineControl.maybe_quiesce arms this with
        # the lease horizon; the next hub pulse sends ONE quiesce beat
        # to this peer and clears it (0 = no handshake pending)
        self._quiesce_lease_ms = 0
        # set while this replicator lingers for a REMOVED peer (it keeps
        # shipping until the peer has the conf entry removing it, or a
        # timeout) — cleared if the peer is re-added meanwhile
        self.retiring = False
        self._transfer_target_index: Optional[int] = None
        self._catchup_waiters: list[tuple[int, asyncio.Future]] = []
        self.inflight_peak = 0  # high-water mark of the batch window
        # send-plane state
        self._sender = None          # EndpointSender (or None: direct mode)
        self._pending = False        # a batch is submitted / in flight
        self._inflight: list[tuple[int, int, int]] = []  # (prev, count, term)
        self._installing = False
        self._install_task: Optional[asyncio.Task] = None
        self._wake_scheduled = False
        self._delay_handle = None    # scheduled delayed pump (backoff)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        node = self._node
        if node.node_manager is not None:
            if node.append_batcher is not None:
                # store-wide write plane: this group's windows join the
                # store's windowed per-destination append rounds
                # (AppendBatcher) instead of the send plane's
                # stop-and-wait endpoint lane — same submit/response
                # contract either way
                self._sender = node.append_batcher
            else:
                self._sender = node.node_manager.send_plane.sender(
                    self.peer.endpoint)
        else:
            self._sender = _DirectSender(self.peer.endpoint)
        self.wake()  # initial probe
        if getattr(node._ctrl, "drives_heartbeats", False):
            # engine control plane: the device tick's hb_due mask beats
            # this replicator (batched via HeartbeatHub.pulse) — no
            # per-replicator clock, no hub clock registration
            return
        hub = None
        opt = node.options.raft_options.coalesce_heartbeats
        if node.node_manager is not None and (
                opt is True or (opt is None and self.peer_multi_hb)):
            # auto mode joins the hub once the peer's capability is
            # known (probe responses advertise it; _note_peer_caps
            # migrates mid-leadership when it is learned later)
            hub = node.node_manager.heartbeat_hub
        self._hub = hub
        if hub is not None:
            hub.register(self)
        else:
            self._hb_task = asyncio.ensure_future(self._heartbeat_loop())

    def stop(self) -> None:
        self._running = False
        if self._hub is not None:
            self._hub.deregister(self)
            self._hub = None
        if self._hb_task:
            self._hb_task.cancel()
            self._hb_task = None
        if self._install_task:
            self._install_task.cancel()
            self._install_task = None
        if self._delay_handle is not None:
            self._delay_handle.cancel()
            self._delay_handle = None
        if isinstance(self._sender, _DirectSender):
            self._sender.stop()
        self._inflight.clear()
        for _, fut in self._catchup_waiters:
            if not fut.done():
                fut.set_result(False)
        self._catchup_waiters.clear()

    def wake(self) -> None:
        """Schedule a pump on the next loop pass (coalesces N wakes per
        pass into one batch build — e.g. a burst of appends)."""
        if self._wake_scheduled or not self._running:
            return
        self._wake_scheduled = True
        asyncio.get_running_loop().call_soon(self._wake_run)

    def _wake_run(self) -> None:
        self._wake_scheduled = False
        if self._running:
            self.pump()

    def _delayed_pump(self, delay_s: float) -> None:
        if not self._running or self._delay_handle is not None:
            return
        loop = asyncio.get_running_loop()

        def fire():
            self._delay_handle = None
            if self._running:
                self.pump()

        self._delay_handle = loop.call_later(delay_s, fire)

    # -- the send plan -------------------------------------------------------

    def pump(self) -> None:
        """Build the next send plan for this (group, peer) and submit it
        to the endpoint sender.  Synchronous: frames snapshot the term
        NOW (a step-down between build and send is caught by the
        receiver's term check + our term_at_send guard)."""
        node = self._node
        if (not self._running or not node.is_leader() or self._pending
                or self._installing):
            return
        lm = node.log_manager
        if self.next_index < lm.first_log_index():
            self._start_install()
            return
        if not self._matched:
            # EMPTY AppendEntries probe (reference: sendEmptyEntries):
            # discovers the follower's match point / backs off
            # next_index; data ships only once matched
            prev_index = self.next_index - 1
            prev_term = lm.get_term(prev_index)
            if prev_index > 0 and prev_term == 0 \
                    and prev_index >= lm.first_log_index():
                # prev entry gone (compacted concurrently)
                first = lm.first_log_index()
                self.next_index = first - 1 if first > 1 else 1
                self._start_install()
                return
            reqs = [self._build_request(prev_index, prev_term, [])]
            self._inflight = [(prev_index, 0, node.current_term)]
        else:
            ropts = node.options.raft_options
            window = max(1, ropts.max_inflight_msgs)
            reqs = []
            self._inflight = []
            next_index = self.next_index
            while (len(reqs) < window
                   and next_index <= lm.last_log_index()):
                prev_index = next_index - 1
                prev_term = lm.get_term(prev_index)
                if prev_index > 0 and prev_term == 0 \
                        and prev_index >= lm.first_log_index():
                    break  # prev compacted under us: probe/install next
                if prev_index < lm.first_log_index() - 1:
                    break  # behind the snapshot
                entries = lm.get_entries(next_index,
                                         ropts.max_entries_size,
                                         ropts.max_body_size)
                if not entries:
                    break
                if self._peer_is_witness():
                    # payload-stripped appends: the witness journals
                    # (index, term) only — a geo witness costs metadata
                    # bytes on the WAN, not the full log stream
                    stripped = [strip_entry_payload(e) for e in entries]
                    saved = sum(len(e.data) for e in entries)
                    if saved:
                        node.metrics.counter("witness-stripped-bytes",
                                             saved)
                    reqs.append(self._build_request(prev_index, prev_term,
                                                    stripped))
                else:
                    reqs.append(self._build_request(prev_index, prev_term,
                                                    entries))
                self._inflight.append((prev_index, len(entries),
                                       node.current_term))
                next_index += len(entries)
            if not reqs:
                if next_index < lm.first_log_index():
                    self._start_install()
                return  # idle: the next wake() re-pumps
            self.next_index = next_index  # optimistic, like the old FIFO
        if len(self._inflight) > self.inflight_peak:
            self.inflight_peak = len(self._inflight)
        self._pending = True
        self._sender.submit_append(self, reqs)

    def _peer_is_witness(self) -> bool:
        return self._node.peer_is_witness(self.peer)

    def _build_request(self, prev_index: int, prev_term: int,
                       entries: list) -> AppendEntriesRequest:
        node = self._node
        req = AppendEntriesRequest(
            group_id=node.group_id,
            server_id=str(node.server_id),
            peer_id=str(self.peer),
            term=node.current_term,
            prev_log_index=prev_index,
            prev_log_term=prev_term,
            committed_index=node.ballot_box.last_committed_index,
            entries=entries)
        if _TRACE.enabled and entries:
            # trailing trace contexts (b"" when no entry is traced):
            # follower-side append/flush spans join the leader's trace
            req.trace_ctx = trace_entry_ctx(entries)
        return req

    # -- batch resolution ----------------------------------------------------

    async def on_batch_responses(self, acks: list) -> None:
        """Resolve one submitted batch, strictly in send order (the old
        inflight-FIFO head loop, one whole window at a time).

        _pending stays True for the WHOLE resolution (cleared in the
        finally): this coroutine awaits mid-loop (step-down, transfer),
        and an external wake pumping a new batch against half-processed
        state would race the rollback paths."""
        inflight, self._inflight = self._inflight, []
        try:
            await self._resolve_batch(inflight, acks)
        finally:
            self._pending = False

    async def _resolve_batch(self, inflight: list, acks: list) -> None:
        node = self._node
        if not self._running:
            return
        eto_s = node.options.election_timeout_ms / 1000.0
        for (prev_index, count, term_at_send), ack in zip(inflight, acks):
            if node.current_term != term_at_send or not node.is_leader():
                self._rollback()
                return
            if isinstance(ack, (ErrorResponse, Exception)) or not hasattr(
                    ack, "success"):
                code = getattr(ack, "code", None)
                if code == int(RaftError.ENOENT):
                    # peer endpoint is up but doesn't host this node
                    # (removed / not yet started): silence, not a storm
                    self._rollback()
                    self._delayed_pump(eto_s / 2)
                else:
                    node.metrics.counter("replicate-error")
                    self._rollback()
                    self._delayed_pump(eto_s / 10)
                return
            self._note_peer_caps(ack)
            self.last_rpc_ack = self._clock.monotonic()
            node.on_peer_ack(self.peer, self.last_rpc_ack)
            if ack.term > node.current_term:
                self._rollback()
                await node.step_down_on_higher_term(
                    ack.term, f"append_entries response from {self.peer}")
                return
            if not ack.success:
                # log mismatch: back off using the follower's hints and
                # re-probe; conflict_index (first index of the
                # follower's conflicting term) skips a whole term run
                # per round trip (classic Raft §5.3 fast backoff)
                was_probe = count == 0 and not self._matched
                before = self.next_index
                self._rollback()
                self._matched = False
                candidates = [prev_index, ack.last_log_index + 1]
                if ack.conflict_index > 0:
                    candidates.append(ack.conflict_index)
                self.next_index = max(1, min(candidates))
                if was_probe and self.next_index == before:
                    # a follower that rejects everything: pace the probe
                    # loop instead of spinning at full speed
                    self._delayed_pump(eto_s / 20)
                else:
                    self.wake()
                return
            # success: follower's log matches through prev + entries
            # (reference: matchIndex = prevLogIndex + entriesCount)
            self._matched = True
            new_match = prev_index + count
            if new_match > self.match_index:
                self.match_index = new_match
                node.on_match_advanced(self.peer, self.match_index)
                self._check_catchup()
            if count:
                node.metrics.counter("replicate-entries-count", count)
        await self._maybe_timeout_now()
        self.wake()  # more entries may have queued while we were out

    async def on_batch_error(self) -> None:
        """The whole batch RPC failed (endpoint unreachable/timeout)."""
        node = self._node
        self._pending = False
        self._rollback()
        if not self._running or not node.is_leader():
            return
        node.metrics.counter("replicate-error")
        self._delayed_pump(node.options.election_timeout_ms / 1000.0 / 10)

    def _rollback(self) -> None:
        """Drop optimistic sends: return next_index to just past the
        last CONFIRMED match."""
        self._inflight = []
        if self._matched:
            self.next_index = max(self.match_index + 1, 1)

    # -- snapshot install ----------------------------------------------------

    def _start_install(self) -> None:
        if self._installing or not self._running:
            return
        self._installing = True

        async def run():
            node = self._node
            try:
                ok = await node.install_snapshot_on(self.peer, self)
                if not ok:
                    await asyncio.sleep(
                        node.options.election_timeout_ms / 1000.0 / 2)
            except asyncio.CancelledError:
                raise
            except Exception:
                LOG.exception("snapshot install to %s failed", self.peer)
            finally:
                self._installing = False
                self._install_task = None
                self.wake()

        self._install_task = asyncio.ensure_future(run())
        self._install_task.add_done_callback(_consume)

    # -- heartbeats ----------------------------------------------------------

    async def _heartbeat_loop(self) -> None:
        node = self._node
        interval = (node.options.election_timeout_ms
                    / node.options.raft_options.election_heartbeat_factor / 1000.0)
        try:
            while self._running and node.is_leader():
                await asyncio.sleep(interval)
                await self.send_heartbeat()
        except asyncio.CancelledError:
            return

    def build_heartbeat_request(self) -> AppendEntriesRequest:
        """The empty AppendEntries beat for this (group, peer) — shared
        by the direct path and the coalescing HeartbeatHub."""
        node = self._node
        lm = node.log_manager
        prev_index = min(self.match_index, lm.last_log_index())
        return AppendEntriesRequest(
            group_id=node.group_id,
            server_id=str(node.server_id),
            peer_id=str(self.peer),
            term=node.current_term,
            prev_log_index=prev_index,
            prev_log_term=lm.get_term(prev_index),
            committed_index=min(node.ballot_box.last_committed_index,
                                prev_index),
            entries=[],
        )

    def _note_peer_caps(self, resp) -> None:
        """Track the peer endpoint's multi_heartbeat capability; in AUTO
        mode (coalesce_heartbeats=None) migrate this replicator's beat
        source between the direct loop and the hub to match it."""
        mh = bool(getattr(resp, "multi_hb", False))
        if mh == self.peer_multi_hb:
            return
        self.peer_multi_hb = mh
        node = self._node
        if (not self._running
                or getattr(node._ctrl, "drives_heartbeats", False)
                or node.options.raft_options.coalesce_heartbeats is not None
                or node.node_manager is None):
            return  # engine beats handle this per-tick; or mode is fixed
        if mh and self._hub is None:
            if self._hb_task is not None:
                self._hb_task.cancel()
                self._hb_task = None
            self._hub = node.node_manager.heartbeat_hub
            self._hub.register(self)
        elif not mh and self._hub is not None:
            self._hub.deregister(self)
            self._hub = None
            self._hb_task = asyncio.ensure_future(self._heartbeat_loop())

    async def process_heartbeat_response(self, resp) -> bool:
        """Ack bookkeeping shared by both heartbeat paths: lease acks,
        step-down on higher term, re-probe on lost match."""
        node = self._node
        if resp.term > node.current_term:
            await node.step_down_on_higher_term(
                resp.term, f"heartbeat response from {self.peer}")
            return False
        self.last_rpc_ack = self._clock.monotonic()
        node.on_peer_ack(self.peer, self.last_rpc_ack)
        if not resp.success and self._matched:
            # follower's log no longer matches (e.g. restarted): re-probe
            self._matched = False
            self.next_index = min(self.next_index, resp.last_log_index + 1) or 1
            self.wake()
        # LAST, with no awaits after: an AUTO-mode migration may cancel
        # the very _hb_task running this coroutine, and a pending
        # CancelledError would abort any later await (observed hazard:
        # swallowing a mandated step-down)
        self._note_peer_caps(resp)
        return True

    async def send_heartbeat(self) -> bool:
        """One empty AppendEntries; returns True on in-term ack.
        Also the quorum-confirmation primitive for ReadIndex (SAFE)."""
        node = self._node
        if not node.is_leader():
            return False
        req = self.build_heartbeat_request()
        t0 = self._clock.monotonic()
        try:
            resp = await node.transport.append_entries(
                self.peer.endpoint, req,
                timeout_ms=node.options.election_timeout_ms // 2 or 1)
        except RpcError:
            return False
        health = node.options.health
        if health is not None:
            # gray-failure signal: the beat's RTT scores the PEER's
            # endpoint — a limping follower shows up here long before
            # it goes silent
            health.note_peer_rtt(self.peer.endpoint,
                                 self._clock.monotonic() - t0)
        return await self.process_heartbeat_response(resp)

    # -- catch-up (membership change) ----------------------------------------

    def wait_matched(self, target: int, timeout_s: float) -> asyncio.Future:
        """Resolves True when match_index reaches ``target``, False on
        timeout or replicator stop."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if self.match_index >= target:
            fut.set_result(True)
            return fut
        self._catchup_waiters.append((target, fut))

        def _timeout():
            if not fut.done():
                fut.set_result(False)

        handle = loop.call_later(timeout_s, _timeout)
        fut.add_done_callback(lambda _f: handle.cancel())
        return fut

    def wait_caught_up(self, margin: int, timeout_s: float) -> asyncio.Future:
        """Resolves True when match_index is within ``margin`` of the log
        tail (reference: Replicator#waitForCaughtUp driving CATCHING_UP)."""
        target = max(1, self._node.log_manager.last_log_index() - margin)
        return self.wait_matched(target, timeout_s)

    def _check_catchup(self) -> None:
        rest = []
        for target, fut in self._catchup_waiters:
            if fut.done():
                continue
            if self.match_index >= target:
                fut.set_result(True)
            else:
                rest.append((target, fut))
        self._catchup_waiters = rest

    # -- leadership transfer -------------------------------------------------

    def transfer_leadership(self, log_index: int) -> None:
        """Send TimeoutNow once this peer's match reaches log_index."""
        self._transfer_target_index = log_index
        if self.match_index >= log_index:
            t = asyncio.ensure_future(self._maybe_timeout_now())
            t.add_done_callback(_consume)
        else:
            self.wake()

    def stop_transfer_leadership(self) -> None:
        """Cancel a pending TimeoutNow trigger (reference:
        Replicator#stopTransferLeadership).  Called when the transfer
        watchdog resumes leadership: without this, a partitioned target
        catching up MUCH later would still receive TimeoutNow and depose
        a leader that long since moved on."""
        self._transfer_target_index = None

    async def _maybe_timeout_now(self) -> None:
        if (self._transfer_target_index is not None
                and self.match_index >= self._transfer_target_index):
            self._transfer_target_index = None
            node = self._node
            req = TimeoutNowRequest(
                group_id=node.group_id,
                server_id=str(node.server_id),
                peer_id=str(self.peer),
                term=node.current_term,
            )
            try:
                await node.transport.timeout_now(self.peer.endpoint, req)
            except RpcError:
                LOG.warning("timeout_now to %s failed", self.peer)


class _DirectSender:
    """Degenerate per-(group, peer) sender for nodes WITHOUT a
    NodeManager (bare unit-test nodes): same submit/response contract as
    EndpointSender, but ships each frame as its own append_entries RPC
    from one transient task per batch."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self._task: Optional[asyncio.Task] = None

    def submit_append(self, rep: Replicator, reqs: list) -> None:
        from tpuraft_torch.core.send_plane import sequential_appends

        self._task = asyncio.ensure_future(
            sequential_appends(rep, self.endpoint, reqs, timed=True))
        self._task.add_done_callback(_consume)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


# graftcheck: loop-confined
class ReplicatorGroup:
    """All replicators of one leader node (reference: ReplicatorGroupImpl)."""

    def __init__(self, node):
        self._node = node
        self._replicators: dict[PeerId, Replicator] = {}

    def add(self, peer: PeerId) -> Replicator:
        r = self._replicators.get(peer)
        if r is not None:
            if not r.retiring:
                return r
            # re-added while lingering for its REMOVAL: the old
            # replicator's match_index may predate a storage wipe —
            # start fresh so the peer re-earns its match from a probe
            # instead of instantly "passing" catch-up with a stale high
            # watermark
            self.remove(peer)
        r = Replicator(self._node, peer)
        self._replicators[peer] = r
        r.start()
        return r

    def remove(self, peer: PeerId) -> None:
        r = self._replicators.pop(peer, None)
        if r:
            r.stop()

    def retire(self, peer: PeerId, min_match_index: int,
               timeout_s: float) -> None:
        """Linger a REMOVED peer's replicator until the peer has received
        the log through ``min_match_index`` (the conf entry that removed
        it — so it steps out instead of starting disruptive elections),
        then stop it.  Bounded by ``timeout_s`` for dead/partitioned
        peers.  A concurrent re-add (membership flap) cancels the
        retirement; a step-down's stop_all wins over it."""
        r = self._replicators.get(peer)
        if r is None:
            return
        r.retiring = True
        if r.match_index >= min_match_index:
            self.remove(peer)
            return
        fut = r.wait_matched(min_match_index, timeout_s)

        def _done(_f):
            if r.retiring and self._replicators.get(peer) is r:
                self.remove(peer)

        fut.add_done_callback(_done)

    def get(self, peer: PeerId) -> Optional[Replicator]:
        return self._replicators.get(peer)

    def stop_all(self) -> None:
        for r in self._replicators.values():
            r.stop()
        self._replicators.clear()

    def progress(self) -> list[tuple[PeerId, int, bool]]:
        """Public snapshot of (peer, next_index, matched) for observability
        (Node#describe, CLI)."""
        return sorted(((p, r.next_index, r._matched)
                       for p, r in self._replicators.items()),
                      key=lambda row: str(row[0]))

    def wake_all(self) -> None:
        for r in self._replicators.values():
            r.wake()

    def peers(self) -> list[PeerId]:
        return list(self._replicators)

    def all(self) -> list[Replicator]:
        return list(self._replicators.values())

    async def heartbeat_round(self) -> int:
        """Concurrent heartbeat to all peers; returns ack count (for SAFE
        ReadIndex quorum confirmation)."""
        if not self._replicators:
            return 0
        results = await asyncio.gather(
            *(r.send_heartbeat() for r in self._replicators.values()),
            return_exceptions=True)
        return sum(1 for x in results if x is True)
