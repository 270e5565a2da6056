"""ReadOnlyService: linearizable reads via ReadIndex / leader lease.

Reference parity: ``core:core/ReadOnlyServiceImpl`` + ``NodeImpl#
handleReadIndexRequest`` (SURVEY.md §3.1, §4.4): batch read requests;
leader confirms its leadership for the batch (SAFE: one heartbeat quorum
round; LEASE_BASED: check the clock lease), pins readIndex = commitIndex,
then resolves once the FSM has applied up to it.  Followers forward to
the leader and wait locally.

Amortization layers (docs/operations.md "Read serving runbook"):
- per group: concurrent readers of one group share one confirmation
  round (``_join_round`` — the reference's batching);
- per store: when a store-level confirm batcher is attached
  (``tpuraft.rheakv.store_engine.ReadConfirmBatcher``), the SAFE quorum
  confirmations of ALL led groups on the store coalesce into one
  beat-plane round — one ``multi_beat_fast`` RPC per destination
  endpoint carries every group's read fence, the same way the
  HeartbeatHub amortizes idle beats;
- lease reads (``ReadOnlyOption.LEASE_BASED``) skip the round entirely,
  and on a HIBERNATING leader are served off the store-level liveness
  lease without waking the group (quiescence composition).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from tpuraft_torch.entity import PeerId
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.options import ReadOnlyOption
from tpuraft_torch.rpc.messages import ReadIndexRequest
from tpuraft_torch.rpc.transport import RpcError

LOG = logging.getLogger(__name__)


class ReadOnlyService:
    def __init__(self, node):
        self._node = node
        self._pending: list[asyncio.Future] = []
        self._round_task: Optional[asyncio.Task] = None
        # follower side: forwarded readIndex requests batch the same way
        # (reference: ReadOnlyServiceImpl batches on every node — one
        # forward RPC serves every reader queued for that round)
        self._fwd_pending: list[asyncio.Future] = []
        self._fwd_task: Optional[asyncio.Task] = None
        # store-level SAFE-confirmation amortizer (attached by the
        # StoreEngine for region groups; None = per-group rounds)
        self._confirm_batcher = None
        # read-plane counters (surfaced via RaftRawKVStore/StoreEngine
        # describe + the bench/soak stats lines)
        self.reads_served = 0     # read_index() calls resolved
        self.lease_serves = 0     # confirmed by the leader lease alone
        self.safe_rounds = 0      # per-group SAFE heartbeat rounds run
        self.batched_confirms = 0  # SAFE confirms amortized store-wide
        self.fwd_rounds = 0       # forward RPCs sent (follower side)
        self.fwd_redirects = 0    # leader-hint re-probes after rejection
        # LEASE_BASED configured but the lease didn't hold (expired,
        # drift-bound shrank it, or the clock sentinel fenced it):
        # the read fell back to a SAFE quorum round — the soak's
        # clock-chaos oracle counts these (ISSUE 18)
        self.lease_fallbacks = 0

    def attach_confirm_batcher(self, batcher) -> None:
        """Route this group's SAFE quorum confirmations through a
        store-wide batcher (``ReadConfirmBatcher.confirm(node) ->
        bool``) so confirmations of many groups share beat-plane RPCs."""
        self._confirm_batcher = batcher

    def counters(self) -> dict:
        return {
            "reads_served": self.reads_served,
            "lease_serves": self.lease_serves,
            "safe_rounds": self.safe_rounds,
            "batched_confirms": self.batched_confirms,
            "fwd_rounds": self.fwd_rounds,
            "fwd_redirects": self.fwd_redirects,
            "lease_fallbacks": self.lease_fallbacks,
        }

    async def shutdown(self) -> None:
        for fut in self._pending + self._fwd_pending:
            if not fut.done():
                fut.set_exception(
                    _read_error(RaftError.ENODESHUTTING, "shutting down"))
        self._pending.clear()
        self._fwd_pending.clear()
        # cancel in-flight confirmation rounds: a round surviving
        # shutdown keeps issuing heartbeat/forward RPCs from a dead node
        for task in (self._round_task, self._fwd_task):
            if task is not None and not task.done():
                task.cancel()
        self._round_task = self._fwd_task = None

    async def read_index(self) -> int:
        """Public entry: returns an index I such that (a) I >= commit index
        at call time as observed by a confirmed leader, and (b) the local
        FSM has applied through I.  Reading local state after this is
        linearizable."""
        node = self._node
        if node.options.witness:
            # a witness is NEVER a read target: its FSM holds no state
            # (payload-stripped journal), so a "linearizable" local read
            # would return nothing at all.  Clients route reads to data
            # replicas; this guard catches whatever slips through.
            raise _read_error(
                RaftError.EPERM,
                "witness replica stores no state (not a read target)")
        if node.is_leader():
            idx = await self.leader_confirm_read_index()
        else:
            idx = await self._forward_to_leader()
        await node.fsm_caller.wait_applied(idx)
        self.reads_served += 1
        return idx

    async def leader_confirm_read_index(self) -> int:
        """Leader side: pin commitIndex, confirm leadership, return index.
        Batching: concurrent callers share one confirmation round."""
        return await self._join_round("_pending", "_round_task",
                                      self._leader_once)

    async def _join_round(self, pending_attr: str, task_attr: str,
                          once) -> int:
        """Enqueue one reader into the named batch and ensure a drain
        task is running; ``once()`` resolves a whole batch to an index
        (or raises for the whole batch)."""
        fut = asyncio.get_running_loop().create_future()
        getattr(self, pending_attr).append(fut)
        task = getattr(self, task_attr)
        if task is None or task.done():
            setattr(self, task_attr, asyncio.ensure_future(
                self._run_rounds(pending_attr, once)))
        return await fut

    async def _run_rounds(self, pending_attr: str, once) -> None:
        # Drain until no requests remain: futures appended WHILE a round
        # is resolving must be picked up by a follow-up round here —
        # callers only spawn a drain task when none is running, so
        # exiting with readers still pending would orphan them until the
        # next request happens to arrive (observed as client-timeout p99
        # tails).  This invariant serves BOTH the leader confirmation
        # rounds and the follower forward rounds.
        while getattr(self, pending_attr):
            batch = getattr(self, pending_attr)
            setattr(self, pending_attr, [])
            try:
                read_index = await once()
            except asyncio.CancelledError:
                # shutdown cancelled the round mid-flight: the batch was
                # already popped from pending, so shutdown()'s sweep
                # can't reach it — fail it here or its readers hang
                for fut in batch:
                    if not fut.done():
                        fut.set_exception(_read_error(
                            RaftError.ENODESHUTTING, "shutting down"))
                raise
            except ReadIndexError as e:
                for fut in batch:
                    if not fut.done():
                        fut.set_exception(_read_error(
                            e.status.raft_error, e.status.error_msg))
                continue
            except Exception as e:  # noqa: BLE001 — transport/storage error
                for fut in batch:
                    if not fut.done():
                        fut.set_exception(_read_error(
                            RaftError.EINTERNAL, f"readIndex round: {e!r}"))
                continue
            for fut in batch:
                if not fut.done():
                    fut.set_result(read_index)

    def _effective_eto_ms(self) -> int:
        """The ADOPTED election timeout: the engine's density floor may
        have raised the node's timeout after construction (EngineControl.
        _adopt_eto), and every read-side budget must track the adopted
        value — a budget derived from a stale shorter timeout times out
        forwarded reads on dense stores during the post-election no-op
        window."""
        ctrl_eto = getattr(self._node._ctrl, "_eto_ms", 0)
        return max(int(ctrl_eto), self._node.options.election_timeout_ms)

    async def _leader_once(self) -> int:
        # a fresh leader briefly cannot serve reads (safety gate below);
        # WAIT for the term's no-op to apply — normally single-digit ms
        # — instead of bouncing every post-election read with an error.
        # Budget: HALF the election timeout, so follower-FORWARDED reads
        # (whose RPC timeout is one election timeout) still get the
        # answer instead of timing out just as the leader resolves.
        node = self._node
        if node.ballot_box.last_committed_index < node._term_first_index:
            try:
                await asyncio.wait_for(
                    node.fsm_caller.wait_applied(node._term_first_index),
                    self._effective_eto_ms() / 2000.0)
            except asyncio.TimeoutError:
                pass   # fall through: _confirm_once fails closed
        ok, read_index = await self._confirm_once()
        if not ok:
            raise _read_error(RaftError.ERAFTTIMEDOUT,
                              "readIndex quorum confirmation failed")
        return read_index

    async def _confirm_once(self) -> tuple[bool, int]:
        node = self._node
        read_index = node.ballot_box.last_committed_index
        # SAFETY GATE: until this leader commits the first entry of its
        # OWN term (the election no-op), its lastCommittedIndex is a
        # follower-time carry-over that may LAG entries the previous
        # leader committed and acked — serving reads against it returns
        # state with acked writes missing (caught by the linearizability
        # soak as a stale read after a leader kill).  Reference:
        # ReadOnlyServiceImpl rejects reads until the current term has
        # a committed entry.
        if read_index < node._term_first_index:
            return False, read_index
        opt = node.options.raft_options.read_only_option
        if opt == ReadOnlyOption.LEASE_BASED:
            if node.leader_lease_is_valid():
                # served off the lease alone — NO quorum round, and no
                # wake: a HIBERNATING leader's lease rides the
                # store-level liveness lease (EngineControl.lease_valid
                # consults store_lease_quorum_ok while quiescent), so a
                # pure-read load leaves quiescent groups hibernated
                self.lease_serves += 1
                return True, read_index
            self.lease_fallbacks += 1
        # SAFE quorum round (or the lease lapsed): the round beats the
        # followers directly, and a beaten follower WAKES — the leader
        # must wake with it or its hibernation outlives its followers'
        # patience and they elect over it.  The wake sits HERE, after
        # the lease check, so lease-served reads never un-hibernate the
        # group (pre-fix: every SAFE-mode read woke it at the top).
        node._ctrl.note_activity()
        voters = len(node.conf_entry.conf.peers)
        if voters <= 1:
            return node.is_leader(), read_index
        if self._confirm_batcher is not None:
            # store-wide amortization: this group's fence rides one
            # beat-plane round shared with every other led group's
            self.batched_confirms += 1
            ok = await self._confirm_batcher.confirm(node)
            return ok and node.is_leader(), read_index
        self.safe_rounds += 1
        acks = 1 + await node.replicators.heartbeat_round()
        return acks >= voters // 2 + 1 and node.is_leader(), read_index

    async def _forward_to_leader(self) -> int:
        """Batched: concurrent forwarded readers share one RPC round.
        Sharing is linearizable — the shared index was obtained by an
        RPC SENT after every sharer's invoke (readers arriving while a
        round is in flight wait for the NEXT round)."""
        return await self._join_round("_fwd_pending", "_fwd_task",
                                      self._forward_once)

    async def _forward_once(self) -> int:
        """One forward round: probe the believed leader; on a rejection
        follow the responder's leader hint (trailing ReadIndexResponse
        field) within the same round — bounded chain, each hop tried
        once.  Exhaustion raises a RETRYABLE status (EAGAIN), never a
        terminal EPERM: 'not the leader' resolves within ~an election
        timeout, and the KV layer's retry engine probes the next
        candidate store exactly like _store_candidates' coverage
        contract promises."""
        node = self._node
        target = node.leader_id
        if target.is_empty():
            raise _read_error(RaftError.EAGAIN, "no known leader")
        tried: set[str] = set()
        last = "no known leader"
        while target is not None and not target.is_empty() \
                and str(target) not in tried and len(tried) < 3:
            tried.add(str(target))
            req = ReadIndexRequest(
                group_id=node.group_id,
                server_id=str(node.server_id),
                peer_id=str(target),
            )
            self.fwd_rounds += 1
            try:
                resp = await node.transport.read_index(
                    target.endpoint, req,
                    timeout_ms=self._effective_eto_ms())
            except RpcError as e:
                raise _read_error(
                    RaftError.ETIMEDOUT,
                    f"readIndex forward to {target} failed") from e
            if resp.success:
                return resp.index
            hint = getattr(resp, "leader_hint", "")
            last = (f"{target} rejected readIndex"
                    + (f"; hinted {hint}" if hint else ""))
            target = None
            if hint:
                try:
                    hinted = PeerId.parse(hint)
                except Exception:  # noqa: BLE001 — malformed hint
                    hinted = None
                if hinted is not None and hinted != node.server_id:
                    self.fwd_redirects += 1
                    target = hinted
        raise _read_error(RaftError.EAGAIN, f"readIndex forward: {last}")


class ReadIndexError(Exception):
    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status


def _read_error(code, msg) -> ReadIndexError:
    return ReadIndexError(Status.error(code, msg))
