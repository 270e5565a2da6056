"""Shared multi-group log engine bindings (native/multilog.cc).

Reference parity: RocksDB as ONE log engine per process — all raft
groups share a write stream and a flush round covers every group with a
single fsync (``core:storage/impl/RocksDBLogStorage`` + RocksDB
WriteBatch; SURVEY.md §3.1 log-storage row, §8.3 "group-sharded column
spaces; batched group-fsync").  Round-1 gap (VERDICT #3): every group
opened its own segment directory, so a process hosting 1K regions held
thousands of fds and issued uncoalesced fsyncs.

Wiring:
  log_uri = "multilog://<dir>#<group_id>"
One :class:`MultiLogEngine` per directory per process (registry below);
each node's :class:`MultiLogStorage` is a per-group view.  Durability:
``append_entries`` stages bytes; the engine's :class:`_GroupCommit`
coalesces every concurrently-flushing group into ONE ``tlm_sync``
(observable via ``sync_count``/``append_count``).  The LogManager uses
the async ``append_entries_async`` hook when present, so flush waiters
are futures, not blocked executor threads.
"""

from __future__ import annotations

import asyncio
import ctypes
import os
import struct
import threading
import time
from typing import Optional

from tpuraft_torch.entity import LogEntry
from tpuraft_torch.storage.log_storage import CorruptLogError, LogStorage

_FRAME = struct.Struct("<I")
_LIB_NAME = "libtpuraft_multilog.so"


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


def ensure_built(timeout: float = 120.0) -> str:
    from tpuraft_torch.util.native_build import ensure_built as _eb
    return _eb(_native_dir(), os.path.join(_native_dir(), _LIB_NAME),
               target=_LIB_NAME, timeout=timeout)


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(ensure_built())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tlm_open.restype = ctypes.c_void_p
            lib.tlm_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int]
            lib.tlm_close.argtypes = [ctypes.c_void_p]
            lib.tlm_register_group.restype = ctypes.c_uint32
            lib.tlm_register_group.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int]
            for name in ("tlm_first", "tlm_last"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.tlm_append.restype = ctypes.c_int64
            lib.tlm_append.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_char_p, ctypes.c_int]
            lib.tlm_sync.restype = ctypes.c_int
            lib.tlm_sync.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
            for name in ("tlm_sync_count", "tlm_append_count",
                         "tlm_file_count", "tlm_gc"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p]
            lib.tlm_get.restype = ctypes.c_int64
            lib.tlm_get.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_int64, ctypes.POINTER(u8p)]
            lib.tlm_free.argtypes = [u8p]
            for name in ("tlm_truncate_prefix", "tlm_truncate_suffix",
                         "tlm_reset"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                               ctypes.c_int64]
            lib.tlm_conf_count.restype = ctypes.c_int64
            lib.tlm_conf_count.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.tlm_conf_indexes.restype = ctypes.c_int64
            lib.tlm_conf_indexes.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
            _lib = lib
        return _lib


def _deliver(f: asyncio.Future, exc: Optional[BaseException]) -> None:
    """Resolve one group-commit waiter; must run on f's own loop."""
    if f.done():
        return
    if exc is not None:
        f.set_exception(exc)
    else:
        f.set_result(None)


class _GroupCommit:
    """Coalesces concurrent flush() calls into one tlm_sync round
    (RocksDB group commit): callers that arrive while a round's fsync is
    in flight wait for the NEXT round, which covers their staged bytes.

    The engine is shared process-wide by directory, so flushers may live
    on DIFFERENT event loops (multi-store processes): the waiter list is
    lock-guarded and each future resolves on its OWN loop — setting a
    future from a foreign loop's thread is not thread-safe."""

    # An inline fsync blocks the event loop, so the fast path self-bans
    # the moment a sync exceeds this (slow/contended disk): stalling the
    # loop stalls heartbeats for EVERY group in the process.
    INLINE_MAX_S = 0.001
    # Gap below which another flush is considered "hot on our heels":
    # take the coalescing round so N concurrent flushers cost one fsync.
    INLINE_IDLE_GAP_S = 0.002

    def __init__(self, engine: "MultiLogEngine"):
        self._engine = engine
        self._lock = threading.Lock()
        self._waiters: list[asyncio.Future] = []   # guarded-by: _lock
        self._task: Optional[asyncio.Task] = None  # guarded-by: _lock
        self._last_sync = 0.0                      # guarded-by: _lock
        # smoothed inline-sync cost (seconds)
        self._cost_ewma = 0.0                      # guarded-by: _lock
        # gray-failure signal sink: a DiskLatencyProbe (util/health.py,
        # itself lock-guarded) fed every measured fsync duration — set
        # by the hosting StoreEngine; None = no health scoring
        self.health_probe = None

    async def flush(self) -> None:
        # LOW-LOAD fast path (VERDICT r2 #3): the executor round costs
        # ~2ms end-to-end on a busy single-core loop (the completion
        # callback queues behind tick + replicator work) while the fsync
        # itself is ~0.1ms on this disk class.  When no round is running
        # and no flush landed within the idle gap, fsync INLINE — the
        # commit-ack path shortens by the round-trip on both the leader
        # and the follower.  Sustained load (back-to-back flushes) keeps
        # the coalescing round: N concurrent flushers -> one fsync.
        with self._lock:
            idle = (self._task is None or self._task.done()) and \
                (time.monotonic() - self._last_sync
                 > self.INLINE_IDLE_GAP_S)
            # NOTE: while banned (ewma >= INLINE_MAX_S) there is no
            # inline re-probe — a probe blocks the loop for the full,
            # unbounded fsync (seconds under writeback stalls), for
            # every group in the process.  The executor round measures
            # each sync instead (in _run) and the same EWMA recovers
            # there, so the fast path re-enables only after the DISK
            # proves fast again, off-loop.
            if idle and self._cost_ewma < self.INLINE_MAX_S \
                    and not self._waiters:
                self._last_sync = time.monotonic()  # claim the window
                inline = True
            else:
                inline = False
                fut = asyncio.get_running_loop().create_future()
                self._waiters.append(fut)
                # done() covers a round task that died without its
                # locked handoff (its loop closed with the task
                # pending): the next flusher revives the group commit
                if self._task is None or self._task.done():
                    self._task = asyncio.ensure_future(self._run())
        if inline:
            t0 = time.perf_counter()
            try:
                self._engine.sync()
            finally:
                dur = time.perf_counter() - t0
                with self._lock:
                    self._last_sync = time.monotonic()
                    # smoothed: one writeback spike doesn't ban the fast
                    # path, a genuinely slow disk does (and keeps it
                    # banned while the ewma stays above the ceiling)
                    self._cost_ewma = 0.7 * self._cost_ewma + 0.3 * dur
                probe = self.health_probe
                if probe is not None:
                    probe.note(dur)
            return
        await fut

    def _timed_sync(self) -> float:
        """engine.sync() + pure in-thread duration (seconds)."""
        t0 = time.perf_counter()
        self._engine.sync()
        return time.perf_counter() - t0

    def _revive(self) -> None:
        """Restart the round on THIS loop — scheduled via
        call_soon_threadsafe when a foreign host loop died mid-round."""
        with self._lock:
            if self._waiters and (self._task is None or self._task.done()):
                self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            with self._lock:
                if not self._waiters:
                    # hand off INSIDE the lock: a flusher on another loop
                    # that observed a still-pending task must not strand
                    # its waiter on a round that already decided to exit
                    self._task = None
                    return
                batch, self._waiters = self._waiters, []
            exc: Optional[BaseException] = None
            try:
                # time the fsync IN the executor thread: timing around
                # the await would fold in the loop round-trip (~2ms) and
                # permanently ban the inline path on any busy process
                dur = await loop.run_in_executor(None, self._timed_sync)
                with self._lock:
                    self._last_sync = time.monotonic()
                    # keep the inline-ban EWMA fed from the executor
                    # path too: this is how a banned fast path recovers
                    # (re-probing inline would block the loop)
                    self._cost_ewma = 0.7 * self._cost_ewma + 0.3 * dur
                probe = self.health_probe
                if probe is not None:
                    probe.note(dur)
            except asyncio.CancelledError:
                # this round's HOST loop is tearing down (asyncio.run
                # cancels pending tasks at exit) — that is not an fsync
                # failure, and waiters on OTHER loops must not see it:
                # requeue the batch, hand the round to every surviving
                # waiter loop (idempotent under the lock), and let the
                # cancellation proceed on this loop
                with self._lock:
                    self._waiters = batch + self._waiters
                    self._task = None
                    for fl in {f.get_loop() for f in self._waiters}:
                        if fl is loop:
                            continue
                        try:
                            fl.call_soon_threadsafe(self._revive)
                        except RuntimeError:
                            pass  # that loop is gone too
                raise
            except Exception as e:  # noqa: BLE001 — fail THIS round only
                exc = e
            for f in batch:
                if f.get_loop() is loop:
                    _deliver(f, exc)
                else:
                    try:
                        f.get_loop().call_soon_threadsafe(_deliver, f, exc)
                    except RuntimeError:
                        pass  # waiter's loop already closed


class MultiLogEngine:
    """One shared journal engine (ctypes handle) + its group-commit."""

    def __init__(self, dir_path: str, segment_max_bytes: int = 0):
        self._lib = _load()
        parent = os.path.dirname(dir_path.rstrip("/"))
        if parent:
            os.makedirs(parent, exist_ok=True)
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.tlm_open(dir_path.encode(), segment_max_bytes,
                                     err, 256)
        if not self._h:
            raise IOError(f"multilog open failed: {err.value.decode()}")
        self.dir = dir_path
        self.group_commit = _GroupCommit(self)
        # capacity-fault hook (tests/soak): a callable taking the byte
        # count about to be staged, raising OSError(ENOSPC) to refuse it
        # — the C++ fd writes are out of Python interposition's reach,
        # so NativeJournalTracker.attach_quota enforces budgets here
        self.fault_gate = None
        self._refs = 0
        # serializes sync vs close: tlm_close deletes the native Store,
        # so closing while an fsync round is mid-flight in any thread
        # (executor, or a foreign loop's cancelled round whose job keeps
        # running) would be a use-after-free.  close() blocks the few ms
        # an in-flight fsync needs; later syncs fail cleanly.
        self._sync_lock = threading.Lock()

    def close(self) -> None:
        with self._sync_lock:
            if self._h:
                self._lib.tlm_close(self._h)
                self._h = None

    def register_group(self, name: str) -> int:
        err = ctypes.create_string_buffer(256)
        gid = self._lib.tlm_register_group(self._h, name.encode(), err, 256)
        if gid == 0:
            raise IOError(f"multilog register failed: {err.value.decode()}")
        return gid

    def sync(self) -> None:
        with self._sync_lock:
            h = self._h
            if not h:
                raise IOError("multilog engine closed")
            err = ctypes.create_string_buffer(256)
            if self._lib.tlm_sync(h, err, 256) != 0:
                raise IOError(f"multilog sync failed: {err.value.decode()}")

    @property
    def sync_count(self) -> int:
        return self._lib.tlm_sync_count(self._h)

    @property
    def append_count(self) -> int:
        return self._lib.tlm_append_count(self._h)

    @property
    def file_count(self) -> int:
        return self._lib.tlm_file_count(self._h)

    def gc(self) -> int:
        return self._lib.tlm_gc(self._h)


# -- process-level engine registry (one engine per directory) ----------------

_engines_lock = threading.Lock()
_engines: dict[str, MultiLogEngine] = {}  # guarded-by: _engines_lock


def peek_engine(dir_path: str) -> Optional[MultiLogEngine]:
    """The live engine for a directory WITHOUT taking a reference —
    observability wiring (the StoreEngine attaching its health probe),
    never ownership."""
    key = os.path.realpath(dir_path)
    with _engines_lock:
        return _engines.get(key)


def get_engine(dir_path: str, segment_max_bytes: int = 0) -> MultiLogEngine:
    key = os.path.realpath(dir_path)
    with _engines_lock:
        eng = _engines.get(key)
        if eng is None or eng._h is None:
            eng = MultiLogEngine(dir_path, segment_max_bytes)
            _engines[key] = eng
        eng._refs += 1
        return eng


def _release_engine(eng: MultiLogEngine) -> None:
    key = os.path.realpath(eng.dir)
    with _engines_lock:
        eng._refs -= 1
        if eng._refs > 0:
            return
        _engines.pop(key, None)
    # close() serializes against any in-flight fsync via the engine's
    # sync lock (blocks the few ms it needs), so closing here is safe
    # even while a round's executor job is still running; that round's
    # waiters — all belonging to already-shutdown stores — get a clean
    # "engine closed" failure if they sync after this point
    eng.close()


class MultiLogStorage(LogStorage):

    CHEAP_CONF_INDEXES = True  # C-side sidecar lookup, no disk I/O
    """Per-group view over the shared engine; selected by
    ``multilog://<dir>#<group_id>``."""

    def __init__(self, dir_path: str, group: str):
        self._dir = dir_path
        self._group = group
        self._eng: Optional[MultiLogEngine] = None
        self._gid = 0
        self._lib = _load()

    @property
    def engine(self) -> MultiLogEngine:
        assert self._eng is not None, "init() first"
        return self._eng

    def init(self) -> None:
        self._eng = get_engine(self._dir)
        self._gid = self._eng.register_group(self._group)

    def shutdown(self) -> None:
        if self._eng is not None:
            _release_engine(self._eng)
            self._eng = None

    def first_log_index(self) -> int:
        return self._lib.tlm_first(self._eng._h, self._gid)

    def last_log_index(self) -> int:
        return self._lib.tlm_last(self._eng._h, self._gid)

    def get_entry(self, index: int) -> Optional[LogEntry]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.tlm_get(self._eng._h, self._gid, index,
                              ctypes.byref(out))
        if n == -2:
            # the index says the record is live but its CRC fails: bit
            # rot of acked data — silently returning None here would
            # read as a hole and could ship garbage to a follower
            raise CorruptLogError(
                f"multilog record for group {self._group} index {index} "
                f"fails CRC — acked entry corrupted")
        if n < 0:
            return None
        try:
            blob = ctypes.string_at(out, n)
        finally:
            self._lib.tlm_free(out)
        return LogEntry.decode(blob)

    def _stage(self, entries: list[LogEntry]) -> int:
        parts = []
        for e in entries:
            blob = e.encode()
            parts.append(_FRAME.pack(len(blob)))
            parts.append(blob)
        frames = b"".join(parts)
        gate = self._eng.fault_gate
        if gate is not None:
            gate(len(frames))
        err = ctypes.create_string_buffer(256)
        n = self._lib.tlm_append(self._eng._h, self._gid, frames,
                                 len(frames), err, 256)
        if n < 0:
            raise ValueError(f"multilog append failed: {err.value.decode()}")
        return n

    def append_entries(self, entries: list[LogEntry], sync: bool = True) -> int:
        """Synchronous path (executor callers): per-call fsync, no
        cross-group coalescing — prefer append_entries_async."""
        if not entries:
            return 0
        n = self._stage(entries)
        if sync:
            self._eng.sync()
        return n

    async def append_entries_async(self, entries: list[LogEntry],
                                   sync: bool = True) -> int:
        """LogManager hook: stage inline (ctypes releases the GIL for
        the buffered write — no executor hop), then join the engine-wide
        group commit — N groups flushing concurrently cost ONE fsync."""
        if not entries:
            return 0
        n = self._stage(entries)
        if sync:
            await self._eng.group_commit.flush()
        return n

    def truncate_prefix(self, first_index_kept: int) -> None:
        if self._lib.tlm_truncate_prefix(self._eng._h, self._gid,
                                         first_index_kept) != 0:
            raise IOError("multilog truncate_prefix failed")
        self._eng.gc()  # opportunistic: drop fully-dead journal files

    def truncate_suffix(self, last_index_kept: int) -> None:
        if self._lib.tlm_truncate_suffix(self._eng._h, self._gid,
                                         last_index_kept) != 0:
            raise IOError("multilog truncate_suffix failed")

    def reset(self, next_log_index: int) -> None:
        if self._lib.tlm_reset(self._eng._h, self._gid, next_log_index) != 0:
            raise IOError("multilog reset failed")

    def configuration_indexes(self) -> list[int]:
        n = self._lib.tlm_conf_count(self._eng._h, self._gid)
        if n == 0:
            return []
        buf = (ctypes.c_int64 * n)()
        got = self._lib.tlm_conf_indexes(self._eng._h, self._gid, buf, n)
        return list(buf[:got])
