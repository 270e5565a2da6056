"""FSMCaller: serialized pipeline into the user StateMachine.

Reference parity: ``core:core/FSMCallerImpl`` (SURVEY.md §3.1) — the
Disruptor + ApplyTaskHandler becomes a single asyncio consumer task; all
StateMachine callbacks (apply batches, snapshot save/load, role events)
run on it in submission order, so user code never sees concurrency.
"""

from __future__ import annotations

import asyncio
from collections import deque
import logging
import time
from typing import Awaitable, Callable, Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.entity import EntryType, LogEntry, LogId, PeerId
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.core.state_machine import Iterator, StateMachine
from tpuraft_torch.util.trace import TRACER as _TRACE

LOG = logging.getLogger(__name__)


class FSMCaller:
    def __init__(self, fsm: StateMachine, log_manager, apply_batch: int = 32,
                 on_error: Optional[Callable[[Status], Awaitable[None]]] = None,
                 health=None, trace_proc: str = "fsm", apply_lane=None):
        self._fsm = fsm
        self._lm = log_manager
        self._apply_batch = apply_batch
        self._node_on_error = on_error
        self._trace_proc = trace_proc
        # apply worker lane (compartmentalization): when set AND the FSM
        # exposes a sync ``apply_sync(it)``, DATA runs execute on the
        # lane thread — the loop only awaits the hop, so a saturated
        # store applies on a second core.  Closures the FSM fires on the
        # lane must be thread-safe (KVClosure hops back via
        # call_soon_threadsafe); the serialized-queue contract holds
        # because _drain awaits each lane hop before the next event.
        self._apply_lane = apply_lane
        self.lane_batches = 0   # apply batches that rode the lane
        # gray-failure signal: committed-minus-applied depth, reported
        # to the store's HealthTracker on every commit advance — a
        # saturated/slow FSM shows up as a growing backlog long before
        # client timeouts do
        self._health = health
        self.last_applied_index = 0
        self.last_applied_term = 0
        self._committed_index = 0
        # apply-plane observability (fleet metrics): batches through
        # on_apply and DATA entries they carried — the store engine
        # aggregates these across regions, so mean entries/batch (the
        # write plane's apply amortization) is scrapeable live
        self.apply_batches = 0
        self.applied_entries = 0
        self._closures: dict[int, Callable[[Status], None]] = {}
        # pipelined apply (Task.ack_at_commit): indices whose closure
        # fires at COMMIT, with the FSM apply running behind in
        # coalesced batches.  Staged in increasing index order (the
        # node stages entries monotonically under its lock), so firing
        # is a popleft scan, not a dict walk.
        self._eager: deque = deque()
        self.eager_acked = 0   # closures fired at commit (observability)
        # demand-spawned drain (r4): a standing task per FSMCaller was
        # O(nodes) standing tasks per process — at 16K groups x 3
        # replicas that alone is 48K idle tasks (the election-starvation
        # regime BENCH_SCALE r3 measured).  Events queue here and one
        # short-lived drain task runs only while events exist.
        self._queue: deque = deque()
        self._task: Optional[asyncio.Task] = None
        self._shut = False
        self._error: Optional[Status] = None
        self._applied_waiters: list[tuple[int, asyncio.Future]] = []
        # node hook: conf entry committed (drives membership-change stages)
        self.on_configuration_applied: Optional[
            Callable[[LogEntry], Awaitable[None]]] = None

    def replace_fsm(self, fsm: StateMachine) -> None:
        """Witness adoption (Node._adopt_witness_mode): swap the user
        FSM for the null witness FSM.  Runs on the node loop between
        queue drains; events already queued simply land on the new FSM
        — their payloads are stripped/irrelevant on a witness."""
        self._fsm = fsm

    async def init(self, bootstrap_id: LogId) -> None:
        self.last_applied_index = bootstrap_id.index
        self.last_applied_term = bootstrap_id.term
        self._committed_index = bootstrap_id.index

    async def shutdown(self) -> None:
        self._enqueue(("shutdown", None))
        if self._task is not None:
            await self._task
            self._task = None

    def _enqueue(self, item) -> None:
        if self._shut:
            return
        self._queue.append(item)
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._drain())

    # -- producers (called from node / ballot box) ---------------------------

    def append_pending_closure(self, index: int, done: Callable[[Status], None],
                               ack_at_commit: bool = False) -> None:
        self._closures[index] = done
        if ack_at_commit:
            self._eager.append(index)

    def fail_pending_closures(self, status: Status) -> None:
        """New leader emerged / stepping down: pending tasks won't commit here."""
        for done in self._closures.values():
            try:
                done(status)
            except Exception:
                LOG.exception("closure failed")
        self._closures.clear()
        self._eager.clear()

    def on_committed(self, index: int) -> None:
        if index <= self._committed_index:
            return
        self._committed_index = index
        if self._health is not None:
            self._health.note_apply_depth(index - self.last_applied_index)
        if self._eager and self._error is None:
            # ack-at-commit: blind writes resolve their proposers NOW —
            # commitment is their linearization point and their result
            # is known a priori — while the FSM applies behind in
            # coalesced batches.  A poisoned pipeline skips this (those
            # closures fail through fail_pending_closures instead).
            while self._eager and self._eager[0] <= index:
                done = self._closures.pop(self._eager.popleft(), None)
                if done is None:
                    continue
                self.eager_acked += 1
                try:
                    done(Status.OK())
                except Exception:
                    LOG.exception("eager closure failed")
        self._enqueue(("committed", index))

    def on_leader_start(self, term: int) -> None:
        self._enqueue(("leader_start", term))

    def on_leader_stop(self, status: Status) -> None:
        self._enqueue(("leader_stop", status))

    def on_start_following(self, leader: PeerId, term: int) -> None:
        self._enqueue(("start_following", (leader, term)))

    def on_stop_following(self, leader: PeerId, term: int) -> None:
        self._enqueue(("stop_following", (leader, term)))

    def on_error(self, status: Status) -> None:
        self._enqueue(("error", status))

    def poison(self, status: Status) -> None:
        """Externally-detected fatal error (e.g. divergence below the
        applied index): poison the apply pipeline exactly like an
        internal `_set_error` — no further committed/snapshot events
        reach the FSM — and deliver `on_error` through the queue.  Sync
        so the node can call it while holding its lock."""
        if self._error is None:
            self._error = status
            self._enqueue(("error", status))

    async def on_snapshot_save(self, writer, done: Callable[[Status], None]) -> None:
        self._enqueue(("snapshot_save", (writer, done)))

    async def on_snapshot_load(self, reader) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._enqueue(("snapshot_load", (reader, fut)))
        return fut

    # -- applied-index waiters (ReadOnlyService) -----------------------------

    def wait_applied(self, index: int) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        if self.last_applied_index >= index:
            fut.set_result(self.last_applied_index)
        else:
            self._applied_waiters.append((index, fut))
        return fut

    def _wake_applied_waiters(self) -> None:
        rest = []
        for idx, fut in self._applied_waiters:
            if fut.done():
                continue
            if self.last_applied_index >= idx:
                fut.set_result(self.last_applied_index)
            else:
                rest.append((idx, fut))
        self._applied_waiters = rest

    # -- consumer ------------------------------------------------------------

    async def _drain(self) -> None:
        while self._queue:
            kind, arg = self._queue.popleft()
            try:
                if kind == "shutdown":
                    self._shut = True
                    await self._fsm.on_shutdown()
                    return
                if self._error is not None and kind not in ("error",):
                    continue  # poisoned: only error propagation continues
                if kind == "committed":
                    await self._do_committed(arg)
                elif kind == "leader_start":
                    await self._fsm.on_leader_start(arg)
                elif kind == "leader_stop":
                    await self._fsm.on_leader_stop(arg)
                elif kind == "start_following":
                    await self._fsm.on_start_following(*arg)
                elif kind == "stop_following":
                    await self._fsm.on_stop_following(*arg)
                elif kind == "snapshot_save":
                    writer, done = arg
                    await self._fsm.on_snapshot_save(writer, done)
                elif kind == "snapshot_save_custom":
                    # SnapshotExecutor wrapper: captures applied-id meta
                    # at the moment the save runs in this serialized queue
                    writer, done, wrapper = arg
                    await wrapper(writer, done)
                elif kind == "snapshot_load":
                    reader, fut = arg
                    try:
                        ok = await self._fsm.on_snapshot_load(reader)
                        if ok:
                            meta = reader.load_meta()
                            self.last_applied_index = meta.last_included_index
                            self.last_applied_term = meta.last_included_term
                            self._committed_index = max(
                                self._committed_index, meta.last_included_index)
                            self._wake_applied_waiters()
                        if not fut.done():
                            fut.set_result(ok)
                    except Exception as exc:
                        if not fut.done():
                            fut.set_exception(exc)
                elif kind == "error":
                    await self._fsm.on_error(arg)
            except Exception:
                LOG.exception("FSMCaller %s handler crashed", kind)
                await self._set_error(Status.error(
                    RaftError.ESTATEMACHINE, f"{kind} handler crashed"))

    async def _set_error(self, status: Status) -> None:
        if self._error is None:
            self._error = status
            try:
                await self._fsm.on_error(status)
            except Exception:
                LOG.exception("on_error crashed")
            if self._node_on_error:
                await self._node_on_error(status)

    async def _do_committed(self, committed_index: int) -> None:
        while self.last_applied_index < committed_index and self._error is None:
            first = self.last_applied_index + 1
            batch_entries: list[LogEntry] = []
            data_entries: list[LogEntry] = []
            closures: list[Optional[Callable[[Status], None]]] = []
            idx = first
            while idx <= committed_index and len(batch_entries) < self._apply_batch:
                e = self._lm.get_entry(idx)
                if e is None:
                    await self._set_error(Status.error(
                        RaftError.EINTERNAL, f"committed entry {idx} missing"))
                    return
                batch_entries.append(e)
                idx += 1
            # split: DATA entries go to user FSM; CONFIGURATION/NO_OP handled
            # by the framework, batch boundaries preserved in order
            pos = 0
            while pos < len(batch_entries):
                e = batch_entries[pos]
                if e.type == EntryType.DATA:
                    run_start = pos
                    while (pos < len(batch_entries)
                           and batch_entries[pos].type == EntryType.DATA):
                        pos += 1
                    run = batch_entries[run_start:pos]
                    run_closures = [self._closures.pop(x.id.index, None) for x in run]
                    it = Iterator(run, run_closures)
                    # trace plane: the apply stage of any traced entry
                    # in this run (one span per traced entry; the run
                    # applies as one batch, so they share the envelope)
                    tids = ([x.trace_id for x in run if x.trace_id]
                            if _TRACE.enabled else [])
                    a0 = time.perf_counter() if tids else 0.0
                    sync_apply = (getattr(self._fsm, "apply_sync", None)
                                  if self._apply_lane is not None else None)
                    try:
                        if sync_apply is not None:
                            # lane apply: the sync body runs on the
                            # store's apply thread; per-op closures hop
                            # back to this loop inside KVClosure, and
                            # post-apply loop-confined bookkeeping
                            # (heat) runs here via on_lane_applied
                            post = await self._apply_lane.submit(
                                sync_apply, it)
                            self.lane_batches += 1
                            post_fn = getattr(self._fsm, "on_lane_applied",
                                              None)
                            if post_fn is not None:
                                post_fn(post)
                        else:
                            await self._fsm.on_apply(it)
                    except Exception:
                        LOG.exception("StateMachine.on_apply crashed")
                        await self._set_error(Status.error(
                            RaftError.ESTATEMACHINE, "on_apply raised"))
                        return
                    self.apply_batches += 1
                    self.applied_entries += len(run)
                    if tids:
                        a1 = time.perf_counter()
                        for tid in tids:
                            _TRACE.span(tid, "fsm_apply", a0, a1,
                                        proc=self._trace_proc,
                                        entries=len(run))
                    if it.stopped_status is not None:
                        await self._set_error(it.stopped_status)
                        return
                    # auto-complete closures the user didn't run
                    for x, done in zip(run, run_closures):
                        if done is not None:
                            try:
                                done(Status.OK())
                            except Exception:
                                LOG.exception("task closure failed")
                    self.last_applied_index = run[-1].id.index
                    self.last_applied_term = run[-1].id.term
                else:
                    if e.type == EntryType.CONFIGURATION:
                        conf = Configuration(list(e.peers or []),
                                             list(e.learners or []),
                                             list(e.witnesses or []))
                        try:
                            await self._fsm.on_configuration_committed(conf)
                        except Exception:
                            LOG.exception("on_configuration_committed crashed")
                        if self.on_configuration_applied is not None:
                            await self.on_configuration_applied(e)
                    done = self._closures.pop(e.id.index, None)
                    if done is not None:
                        try:
                            done(Status.OK())
                        except Exception:
                            LOG.exception("conf closure failed")
                    self.last_applied_index = e.id.index
                    self.last_applied_term = e.id.term
                    pos += 1
            self._lm.set_applied_index(self.last_applied_index)
            self._wake_applied_waiters()
