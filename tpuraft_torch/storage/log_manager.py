"""LogManager: in-memory log window + async batched stable storage.

Reference parity: ``core:storage/impl/LogManagerImpl`` (SURVEY.md §3.1,
§4.2) — the Disruptor + AppendBatcher pipeline becomes an asyncio flusher
task that coalesces concurrent appends into one storage write + fsync
(storage I/O runs in a thread executor so the event loop never blocks);
wait-listeners wake Replicators when the log grows; follower-side conflict
resolution (``#checkAndResolveConflict``) truncates divergent suffixes;
``#setSnapshot`` compacts the prefix after snapshots.

Single-writer discipline: all public methods must be called from the
node's event loop (the functional analog of LogManagerImpl's lock).
"""

from __future__ import annotations

import asyncio
from collections import deque
import logging
import time
from dataclasses import dataclass
from typing import Optional

from tpuraft_torch.conf import ConfigurationEntry, ConfigurationManager
from tpuraft_torch.entity import EntryType, LogEntry, LogId
from tpuraft_torch.errors import RaftError, RaftException, Status
from tpuraft_torch.util.trace import TRACER as _TRACE

LOG = logging.getLogger(__name__)


def _is_enospc(exc: BaseException) -> bool:
    import errno

    return getattr(exc, "errno", None) == errno.ENOSPC \
        or "ENOSPC" in str(exc) or "no space left" in str(exc).lower()


@dataclass
class _FlushReq:
    entries: list[LogEntry]
    future: asyncio.Future


# graftcheck: loop-confined — single-writer discipline (see module
# docstring): storage IO hops to executor threads, the manager's own
# state never does
class LogManager:
    def __init__(
        self,
        storage,
        conf_manager: Optional[ConfigurationManager] = None,
        sync: bool = True,
        max_flush_batch: int = 256,
        max_logs_in_memory: int = 256,
        max_logs_in_memory_bytes: int = 256 * 1024,
        health=None,
        trace_proc: str = "",
        disk_budget=None,
    ):
        self._storage = storage
        # capacity accounting: the store-level DiskBudget this flusher
        # feeds append bytes into (and ENOSPC observations — the
        # pressure ladder trusts the errno over its own estimate)
        self._disk_budget = disk_budget
        # trace-plane process identity for flush spans (the owning
        # node's store endpoint; "" for bare/legacy constructions)
        self._trace_proc = trace_proc or "log"
        # gray-failure signal: the store-level HealthTracker whose disk
        # probe this flusher times every flush round into (append +
        # fsync, executor queueing included — CPU saturation IS a gray
        # signal).  The probe's begin/end also exposes the AGE of a
        # still-in-flight flush, which is how a fully hung fsync is
        # detected (it never completes a sample).
        self._health = health
        self.conf_manager = conf_manager or ConfigurationManager()
        self._sync = sync
        self._max_flush_batch = max_flush_batch
        # retained recent window beyond stability/apply, so replication to
        # slightly-lagging followers is served from memory, not disk
        # (reference: LogManagerImpl's logsInMemory / maxLogsInMemory).
        # Both caps are per group; the bytes cap bounds multi-group RAM.
        self._max_in_memory = max_logs_in_memory
        self._max_in_memory_bytes = max_logs_in_memory_bytes

        self._mem: dict[int, LogEntry] = {}  # unstable + recent window
        self._mem_bytes = 0      # sum of len(e.data) over _mem
        self._trim_floor = 0     # all indexes <= this are trimmed from _mem
        self._first_index = 1
        self._last_index = 0          # includes unstable entries
        self._stable_index = 0        # flushed to storage
        self._applied_index = 0
        self._last_snapshot_id = LogId(0, 0)

        self._staged: list[LogEntry] = []
        self._stable_waiters: list[tuple[int, asyncio.Future]] = []
        # demand-spawned flusher (r4): a standing flush task per node is
        # O(nodes) idle tasks per process (48K at the 16Kx3 ladder rung);
        # requests queue here and one short-lived drain runs while any
        # exist.  Single-drainer + FIFO deque keeps flush order, which
        # _stable_index and the on_stable hook rely on.
        self._queue: deque = deque()
        self._inflight_flushes = 0
        self._flush_idle = asyncio.Event()
        self._flush_idle.set()
        self._flusher: Optional[asyncio.Task] = None
        self._waiters: list[tuple[int, asyncio.Future]] = []
        self._stopped = False
        # durable-advance hook: called with the new stable index after
        # every storage flush — the bridge that ships this replica's
        # (group, lastDurableIndex) into a replica-axis commit plane
        # (tpuraft.parallel.replica_plane; SURVEY §6 "ships (groupId,
        # peerId, lastLogIndex) tick-tensors ... into the JAX process")
        self.on_stable = None  # Optional[Callable[[int], None]]
        # storage-failure hook: called (with the exception) after a
        # flush round fails and its futures/waiters were failed — the
        # node maps this to leader step-down (clients get retryable
        # errors) instead of process death; see ISSUE 17 layer 4
        self.on_storage_error = None  # Optional[Callable[[BaseException], None]]

    # -- lifecycle ----------------------------------------------------------

    async def init(self) -> None:
        self._storage.init()
        self._first_index = self._storage.first_log_index()
        self._last_index = self._storage.last_log_index()
        self._stable_index = self._last_index
        # _mem is empty after init: everything recovered lives in storage,
        # so the incremental trim must start from the recovered tail (a
        # floor of 0 would make the first trim walk the whole log range)
        self._trim_floor = self._last_index
        # rebuild configuration history from the stored log (sidecar index:
        # O(#conf entries), not O(n) — see LogStorage#configuration_indexes).
        # Storages whose sidecar is an in-memory/C-side lookup advertise
        # CHEAP_CONF_INDEXES: the executor hop is pure overhead for them,
        # and at high group counts one hop per node serializes into tens
        # of seconds of boot (16K-groups ladder, VERDICT r3 #7).
        if getattr(self._storage, "CHEAP_CONF_INDEXES", False):
            conf_indexes = self._storage.configuration_indexes()
        else:
            loop = asyncio.get_running_loop()
            conf_indexes = await loop.run_in_executor(
                None, self._storage.configuration_indexes)
        for i in conf_indexes:
            e = self._storage.get_entry(i)
            if e and e.type == EntryType.CONFIGURATION:
                self._track_conf(e)

    async def shutdown(self) -> None:
        self._stopped = True
        if self._flusher is not None and not self._flusher.done():
            await self._flusher
        self._wake_waiters(error=True)
        self._storage.shutdown()

    # -- queries ------------------------------------------------------------

    def first_log_index(self) -> int:
        return self._first_index

    def last_log_index(self) -> int:
        return self._last_index

    def last_log_id(self) -> LogId:
        if self._last_index == self._last_snapshot_id.index:
            return self._last_snapshot_id
        return LogId(self._last_index, self.get_term(self._last_index))

    def last_snapshot_id(self) -> LogId:
        return self._last_snapshot_id

    def _mem_put(self, e) -> None:
        prev = self._mem.get(e.id.index)
        if prev is not None:
            self._mem_bytes -= len(prev.data)
        self._mem[e.id.index] = e
        self._mem_bytes += len(e.data)

    def _mem_pop(self, index: int) -> None:
        e = self._mem.pop(index, None)
        if e is not None:
            self._mem_bytes -= len(e.data)

    def get_entry(self, index: int) -> Optional[LogEntry]:
        if index > self._last_index or index < self._first_index:
            return None
        e = self._mem.get(index)
        if e is not None:
            return e
        return self._storage.get_entry(index)

    def get_term(self, index: int) -> int:
        if index == 0:
            return 0
        if index == self._last_snapshot_id.index:
            return self._last_snapshot_id.term
        e = self.get_entry(index)
        return e.id.term if e else 0

    def conflict_hint(self, prev_index: int,
                      prev_term: Optional[int] = None) -> int:
        """Start index of the term run containing ``prev_index`` in OUR
        log — returned to a leader whose prev-term probe mismatched, so
        its next probe skips the conflicting term run (classic Raft
        fast-backoff).  The walk only consults the in-memory window:
        this runs under the node lock on the event loop, so it must
        never fall through to storage reads.  A partial walk still
        returns a correct (just less aggressive) probe point; 0 = no
        hint."""
        t = prev_term if prev_term is not None else self.get_term(prev_index)
        if t == 0:
            return 0
        i = prev_index
        while i - 1 >= self._first_index:
            e = self._mem.get(i - 1)
            if e is None or e.id.term != t:
                break
            i -= 1
        return i

    def get_entries(self, from_index: int, max_count: int, max_bytes: int
                    ) -> list[LogEntry]:
        """Contiguous batch for replication, bounded by count and bytes."""
        out: list[LogEntry] = []
        size = 0
        i = from_index
        while i <= self._last_index and len(out) < max_count:
            e = self.get_entry(i)
            if e is None:
                break
            size += len(e.data)
            if out and size > max_bytes:
                break
            out.append(e)
            i += 1
        return out

    # -- appends ------------------------------------------------------------

    def stage_leader_entries(self, entries: list[LogEntry], term: int) -> LogId:
        """Leader: assign indexes/terms, make entries visible to replicators
        (in-memory) — synchronous, call under the node lock.  Durability
        comes from a following :meth:`flush_staged`."""
        for e in entries:
            self._last_index += 1
            e.id = LogId(self._last_index, term)
            self._mem_put(e)
            if e.type == EntryType.CONFIGURATION:
                self._track_conf(e)
        self._staged.extend(entries)
        self._wake_waiters()
        return LogId(self._last_index, term)

    async def flush_staged(self, upto: Optional[int] = None) -> None:
        """Flush all staged entries; resolves once the log is stable up to
        ``upto`` (default: everything staged so far).  Safe to call from
        multiple appliers concurrently — whoever runs first carries the
        whole staged batch; the rest wait on the stable watermark."""
        batch, self._staged = self._staged, []
        # default target: the full staged watermark (_last_index), NOT the
        # stable index — if another applier stole our staged batch we must
        # still wait for our entries' fsync before self-granting a vote
        target = upto if upto is not None else self._last_index
        if batch:
            await self._enqueue_flush(batch)
        if self._stable_index >= target:
            return
        fut = asyncio.get_running_loop().create_future()
        self._stable_waiters.append((target, fut))
        await fut

    async def append_entries_leader(self, entries: list[LogEntry], term: int
                                    ) -> LogId:
        """stage + flush in one call (single-applier convenience)."""
        last_id = self.stage_leader_entries(entries, term)
        await self.flush_staged(last_id.index)
        return last_id

    async def append_entries_follower(self, prev_log_index: int, prev_log_term: int,
                                      entries: list[LogEntry]) -> bool:
        """Conflict-checked follower append (#checkAndResolveConflict).

        Returns False when prev_log does not match (leader must back off).
        """
        if prev_log_index > self._last_index:
            return False  # gap: we don't have prev yet
        if prev_log_index >= self._first_index or (
            prev_log_index == self._last_snapshot_id.index
        ):
            if self.get_term(prev_log_index) != prev_log_term:
                return False
        # else: prev lies in the compacted region (its term is unknowable
        # unless it is the snapshot index) — those entries were committed,
        # so Raft's Log Matching property guarantees agreement.
        if not entries:
            return True
        # skip entries we already have with matching terms
        keep_from = 0
        for i, e in enumerate(entries):
            if (e.id.index < self._first_index
                    or e.id.index <= self._last_snapshot_id.index):
                # already compacted => committed; a stale retransmission
                keep_from = i + 1
                continue
            if e.id.index > self._last_index:
                keep_from = i
                break
            if self.get_term(e.id.index) != e.id.term:
                # conflict: truncate our suffix from this index
                if e.id.index <= self._applied_index:
                    raise RaftException(Status.error(
                        RaftError.EINTERNAL,
                        f"conflict at applied index {e.id.index}"))
                await self._truncate_suffix(e.id.index - 1)
                keep_from = i
                break
            keep_from = i + 1
        new_entries = entries[keep_from:]
        if not new_entries:
            return True
        # Deferred wire-CRC check, once per entry actually staged (the
        # wire decode skips it for speed): a blob corrupted past TCP's
        # 16-bit checksum must NOT reach the journal — recovery scans
        # would later mistake it for a torn tail and silently truncate
        # acked suffix entries.  Rejecting here makes the leader back
        # off and retransmit, turning corruption into a transient.
        try:
            for e in new_entries:
                e.verify_crc()
        except ValueError:
            LOG.warning("rejecting AppendEntries batch: wire CRC mismatch "
                        "at index %d", e.id.index)
            return False
        for e in new_entries:
            self._mem_put(e)
            self._last_index = e.id.index
            if e.type == EntryType.CONFIGURATION:
                self._track_conf(e)
        await self._enqueue_flush(new_entries)
        self._wake_waiters()
        return True

    def _track_conf(self, e: LogEntry) -> None:
        from tpuraft_torch.conf import Configuration

        ce = ConfigurationEntry(
            id=e.id,
            conf=Configuration(list(e.peers or []), list(e.learners or []),
                               list(e.witnesses or [])),
            old_conf=Configuration(list(e.old_peers or []),
                                   list(e.old_learners or []),
                                   list(e.old_witnesses or [])),
        )
        self.conf_manager.add(ce)

    # -- flush pipeline ------------------------------------------------------

    async def _enqueue_flush(self, entries: list[LogEntry]) -> None:
        fut = asyncio.get_running_loop().create_future()
        self._inflight_flushes += 1
        self._flush_idle.clear()
        try:
            self._queue.append(_FlushReq(entries, fut))
            if self._flusher is None or self._flusher.done():
                self._flusher = asyncio.ensure_future(self._flush_loop())
            await fut
        finally:
            self._inflight_flushes -= 1
            if self._inflight_flushes == 0:
                self._flush_idle.set()

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while self._queue:
            batch = [self._queue.popleft()]
            # coalesce everything already queued (AppendBatcher)
            while self._queue and len(batch) < self._max_flush_batch:
                batch.append(self._queue.popleft())
            entries = [e for r in batch for e in r.entries]
            try:
                if entries:
                    # shared-engine storages expose an async hook whose
                    # fsync joins a cross-GROUP commit round (multilog);
                    # classic storages block an executor thread
                    append_async = getattr(
                        self._storage, "append_entries_async", None)
                    health = self._health
                    # trace plane: spans for the traced entries of this
                    # flush round — timed IN the executor thread (the
                    # PR 11 health-probe discipline: awaited duration
                    # folds in executor-queue wait and a co-hosted
                    # neighbor's slow disk would contaminate THIS
                    # store's attribution exactly like it did the EMA)
                    tids = ([e.trace_id for e in entries if e.trace_id]
                            if _TRACE.enabled else [])
                    tok = health.disk.begin() if health is not None else None
                    try:
                        if append_async is not None:
                            # multilog: the group commit times its fsync
                            # IN the executor thread and feeds the EMA
                            # itself (StoreEngine wires the probe);
                            # begin/end here covers only the stall age.
                            # The awaited envelope is the best span
                            # available here (the commit round is
                            # shared, not per-group).
                            f0 = time.perf_counter()
                            await append_async(entries, self._sync)
                            f1 = time.perf_counter()
                        elif health is not None or tids:
                            # time the append+fsync IN the executor
                            # thread: end-to-end (awaited) duration
                            # would fold in executor-queue wait, and a
                            # co-hosted neighbor's slow disk must not
                            # score THIS store's disk sick
                            def _timed(entries=entries):
                                t0 = time.perf_counter()
                                self._storage.append_entries(entries,
                                                             self._sync)
                                return t0, time.perf_counter()

                            f0, f1 = await loop.run_in_executor(None, _timed)
                            if health is not None:
                                health.disk.note(f1 - f0)
                        else:
                            await loop.run_in_executor(
                                None, self._storage.append_entries, entries,
                                self._sync)
                    finally:
                        if tok is not None:
                            health.disk.end(tok)
                    if tids:
                        for tid in tids:
                            _TRACE.span(tid, "log_flush", f0, f1,
                                        proc=self._trace_proc,
                                        entries=len(entries))
                    self._stable_index = max(self._stable_index, entries[-1].id.index)
                    if self._disk_budget is not None:
                        # ~32B/entry framing+index overhead on top of
                        # payload — an estimate; the periodic reconcile
                        # re-bases on real usage
                        self._disk_budget.note_append(
                            sum(len(e.data) for e in entries)
                            + 32 * len(entries))
                    if self.on_stable is not None:
                        self.on_stable(self._stable_index)
                for r in batch:
                    if not r.future.done():
                        r.future.set_result(True)
                self._wake_stable_waiters()
            except Exception as exc:
                # storage failure is fatal for the LEADERSHIP, not the
                # process: every waiter gets a retryable error and the
                # on_storage_error hook steps the node down — never ack,
                # never silently drop (ISSUE 17 layer 4)
                LOG.exception("log flush failed")
                if self._disk_budget is not None and _is_enospc(exc):
                    self._disk_budget.note_enospc()
                err = RaftException(Status.error(RaftError.EIO, str(exc)))
                # Fail EVERYTHING in flight — this batch, every queued
                # request, the staged-but-unflushed tail — then roll the
                # in-memory frontier back to what storage actually
                # holds.  None of the failed suffix was ever acked, so
                # dropping it is the follower-conflict-truncate case,
                # not data loss; KEEPING it permanently desyncs memory
                # from disk — the next append dies "non-contiguous" in
                # storage and the node wedges in ERROR state (found by
                # the --disk-pressure soak's ENOSPC bursts).
                while self._queue:
                    batch.append(self._queue.popleft())
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(err)
                self._staged.clear()
                durable = max(self._storage.last_log_index(),
                              self._first_index - 1)
                for i in range(durable + 1, self._last_index + 1):
                    self._mem_pop(i)
                if durable < self._last_index:
                    self.conf_manager.truncate_suffix(durable)
                self._last_index = durable
                self._stable_index = min(self._stable_index, durable)
                for _, fut in self._stable_waiters:
                    if not fut.done():
                        fut.set_exception(err)
                self._stable_waiters.clear()
                cb = self.on_storage_error
                if cb is not None:
                    try:
                        cb(exc)
                    except Exception:
                        LOG.exception("on_storage_error hook failed")

    def _wake_stable_waiters(self) -> None:
        rest = []
        for target, fut in self._stable_waiters:
            if fut.done():
                continue
            if self._stable_index >= target:
                fut.set_result(None)
            else:
                rest.append((target, fut))
        self._stable_waiters = rest

    async def _drain_flushes(self) -> None:
        """Wait until every in-flight flush completed (before truncation —
        the reference funnels truncates through the same disruptor for the
        same ordering guarantee)."""
        await self._flush_idle.wait()

    async def _truncate_suffix(self, last_index_kept: int) -> None:
        await self._drain_flushes()
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._storage.truncate_suffix, last_index_kept)
        for i in range(last_index_kept + 1, self._last_index + 1):
            self._mem_pop(i)
        self._trim_floor = min(self._trim_floor, last_index_kept)
        self._last_index = last_index_kept
        self._stable_index = min(self._stable_index, last_index_kept)
        self.conf_manager.truncate_suffix(last_index_kept)
        if self.on_stable is not None:
            # the durable tip MOVED DOWN: replica-plane rows must follow
            # (a stale-high row would count truncated entries toward a
            # quorum — the divergent-suffix hazard)
            self.on_stable(self._stable_index)

    # -- snapshot interaction ------------------------------------------------

    async def set_snapshot(self, snapshot_id: LogId, conf: ConfigurationEntry,
                           keep_margin: int = 0) -> None:
        """Record a completed snapshot and compact the log prefix
        (reference: LogManagerImpl#setSnapshot + truncatePrefix)."""
        if snapshot_id.index <= self._last_snapshot_id.index:
            return
        term_here = self.get_term(snapshot_id.index)  # before updating snapshot id
        self._last_snapshot_id = snapshot_id
        self.conf_manager.set_snapshot(conf)
        first_kept = snapshot_id.index + 1 - keep_margin
        if term_here == snapshot_id.term:
            # local log agrees with the snapshot: keep the tail after it
            first_kept = min(first_kept, snapshot_id.index + 1)
        elif (term_here == 0 and self._first_index == snapshot_id.index + 1
                and self._last_index >= snapshot_id.index):
            # Boot-after-compaction: the entry AT the snapshot index was
            # already pruned (margin 0), so its term is unknowable — but
            # the stored tail starts exactly at snapshot.index + 1, i.e.
            # it was appended contiguously after the snapshot point and
            # Log Matching vouches for it.  KEEP it.  Treating term 0 as
            # divergence here reset the log and silently dropped the
            # whole acked suffix on every reboot that followed a
            # completed compaction — two such amnesiac reboots in one
            # fault window break quorum intersection and un-commit acked
            # writes (found by the power-loss soak, examples/soak.py
            # --power-loss; regression: tests/test_storage_fault.py).
            # The reference resets only on a KNOWN different term
            # (LogManagerImpl#setSnapshot: term == 0 -> truncatePrefix).
            return
        else:
            # log diverges from (or predates) the snapshot: drop everything
            await self._drain_flushes()
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, self._storage.reset, snapshot_id.index + 1)
            self._mem.clear()
            self._mem_bytes = 0
            self._trim_floor = snapshot_id.index
            self._first_index = snapshot_id.index + 1
            self._last_index = snapshot_id.index
            self._stable_index = snapshot_id.index
            self.conf_manager.truncate_prefix(self._first_index)
            if self.on_stable is not None:
                self.on_stable(self._stable_index)  # tip moved (reset)
            return
        first_kept = max(self._first_index, first_kept)
        if first_kept > self._first_index:
            await self._drain_flushes()
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._storage.truncate_prefix, first_kept)
            for i in range(self._first_index, first_kept):
                self._mem_pop(i)
            self._trim_floor = max(self._trim_floor, first_kept - 1)
            self._first_index = first_kept
            self.conf_manager.truncate_prefix(first_kept)

    def set_applied_index(self, index: int) -> None:
        self._applied_index = max(self._applied_index, index)
        # trim the in-memory window: stable AND applied entries can be
        # dropped, but keep a recent window (bounded by count AND bytes)
        # so replication reads stay off disk in the steady state.
        # Incremental: walk from the trim floor, never rescan _mem.
        trim_to = min(self._applied_index, self._stable_index,
                      self._last_index - self._max_in_memory)
        for i in range(self._trim_floor + 1, trim_to + 1):
            self._mem_pop(i)
        self._trim_floor = max(self._trim_floor, trim_to)
        # bytes cap: evict more of the oldest retained entries while
        # over budget, but never unstable or unapplied ones
        hard_to = min(self._applied_index, self._stable_index)
        i = self._trim_floor + 1
        while self._mem_bytes > self._max_in_memory_bytes and i <= hard_to:
            self._mem_pop(i)
            i += 1
        self._trim_floor = max(self._trim_floor, i - 1)

    # -- waiters (replicator wakeup) -----------------------------------------

    def wait_for(self, index: int) -> asyncio.Future:
        """Future resolving True when last_log_index >= index (or False on
        shutdown). Reference: LogManager#wait + wakeupAllWaiter."""
        fut = asyncio.get_running_loop().create_future()
        if self._last_index >= index or self._stopped:
            fut.set_result(self._last_index >= index)
            return fut
        self._waiters.append((index, fut))
        return fut

    def _wake_waiters(self, error: bool = False) -> None:
        rest: list[tuple[int, asyncio.Future]] = []
        for idx, fut in self._waiters:
            if fut.done():
                continue
            if error:
                fut.set_result(False)
            elif self._last_index >= idx:
                fut.set_result(True)
            else:
                rest.append((idx, fut))
        self._waiters = rest

    # -- consistency ---------------------------------------------------------

    def check_consistency(self) -> Status:
        if self._first_index == 1 and self._last_snapshot_id.index == 0:
            return Status.OK()
        if (self._last_snapshot_id.index >= self._first_index - 1
                and self._last_snapshot_id.index <= self._last_index):
            return Status.OK()
        if self._last_snapshot_id.index == self._last_index:
            return Status.OK()
        return Status.error(
            RaftError.EINTERNAL,
            f"inconsistent log: first={self._first_index} last={self._last_index} "
            f"snapshot={self._last_snapshot_id.index}",
        )
