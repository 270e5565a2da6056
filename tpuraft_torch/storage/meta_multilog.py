"""Shared multi-group {term, votedFor} journal with group-commit fsync.

Reference parity: ``core:storage/impl/LocalRaftMetaStorage`` semantics —
{term, votedFor} is fsynced before a vote is cast or a term adopted —
at multi-raft density (SURVEY.md §3.1 "synced on change", §3.5 cluster
sharding).  The reference pays one ProtoBufFile fsync per group per
change; a 16K-group election herd on one process would issue 16K fsyncs
serially through the executor, which is exactly the r3 starvation
regime.  Here every group of a process appends its meta record to ONE
shared journal whose flushes coalesce through the same group-commit
*machinery* the multilog uses
(:class:`tpuraft.storage.multilog._GroupCommit`) — but over its own
file and its own rounds, so meta saves coalesce with other meta saves,
not with log-entry fsyncs (an election plus an append burst pays two
fsync rounds, one per journal): N groups voting concurrently still cost
one meta fsync.

Wiring::

    raft_meta_uri = "multimeta://<dir>#<group_id>"

One :class:`MetaJournal` per directory per process (registry below);
each node's :class:`MultiRaftMetaStorage` is a per-group facade exposing
the synchronous ``RaftMetaStorage`` interface plus ``save_async`` —
``Node._persist_meta`` awaits that, so an election herd's meta persists
ride shared fsync rounds instead of serial executor hops.

On-disk format (``meta.jnl``): repeated
``[u16 glen | group | i64 term | u16 vlen | votedFor | u32 crc]``,
last record per group wins.  Durability watermark (``meta.jnl.synced``)
follows the FileLogStorage discipline: a scan failure BELOW the
watermark is loud corruption (an acked vote may be lost — restarting
blind could double-vote), at/above it is a truncatable torn tail (that
save was never acked).  The journal compacts in place (tmp + fsync +
rename) once garbage dominates.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from typing import Optional

from tpuraft_torch.entity import EMPTY_PEER, PeerId
from tpuraft_torch.storage.log_storage import (
    CorruptLogError,
    _fsync_dir,
    load_crc_watermark,
    save_crc_watermark,
)
from tpuraft_torch.storage.meta_storage import RaftMetaStorage

_HDR = struct.Struct("<H")      # group / votedFor length prefixes
_TERM = struct.Struct("<q")
_CRC = struct.Struct("<I")

_JNL = "meta.jnl"
_WM = "meta.jnl.synced"

LOG = logging.getLogger(__name__)


def _record(group: bytes, term: int, voted: bytes) -> bytes:
    payload = _HDR.pack(len(group)) + group + _TERM.pack(term) \
        + _HDR.pack(len(voted)) + voted
    return payload + _CRC.pack(zlib.crc32(payload))


class MetaJournal:
    """One shared meta journal + group-commit (one per directory)."""

    # compact when the journal carries ~8x more records than live groups
    # (and is big enough for the rewrite to matter)
    COMPACT_MIN_BYTES = 256 * 1024

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        # guards the file handle, the value map and compaction: stagers
        # run on event loops, the fsync runs in executor threads
        self._lock = threading.Lock()
        # serializes whole fsync rounds with compaction's file-handle
        # swap and with close() (mirrors the native engine's sync_mu):
        # without it, a synchronous _save-path sync() racing a
        # group-commit round's compaction would fsync a closed handle —
        # ValueError remapped to a spurious IOError("meta journal
        # closed") failing every waiter in the batch.  Lock order:
        # _sync_lock -> _lock, never the reverse; stage() takes only
        # _lock so staging never stalls behind a flush.
        self._sync_lock = threading.Lock()
        self._values: dict[bytes, tuple[int, bytes]] = {}  # guarded-by: _lock
        self._f = None      # guarded-by: _lock
        self._size = 0      # guarded-by: _lock
        # bytes proven durable by a completed fsync
        self._synced = 0    # guarded-by: _lock
        self._refs = 0
        self.sync_count = 0
        self.save_count = 0
        self._open()
        from tpuraft_torch.storage.multilog import _GroupCommit

        self.group_commit = _GroupCommit(self)

    # -- recovery ------------------------------------------------------------

    def _path(self) -> str:
        return os.path.join(self.dir, _JNL)

    def _wm_path(self) -> str:
        return os.path.join(self.dir, _WM)

    def _load_wm(self) -> int:
        # CRC-guarded (see load_crc_watermark): garbage degrades to 0 =
        # nothing proven, which always falls back to torn-tail semantics
        vals = load_crc_watermark(self._wm_path(), 8)
        return struct.unpack("<q", vals)[0] if vals is not None else 0

    def _save_wm(self, sync: bool) -> None:  # graftcheck: holds(_lock)
        try:
            save_crc_watermark(self._wm_path(), self.dir,
                               struct.pack("<q", self._synced), sync)
        except OSError:
            # same policy as FileLogStorage._save_watermark: the
            # sync=True save is the compaction FLOOR and must abort the
            # compaction on failure; the non-sync saves (open, close,
            # post-compaction refresh) only ADVANCE the watermark, and
            # stale-LOW always degrades to torn-tail scan semantics —
            # ENOSPC on the watermark tmp must not fail close/boot
            if sync:
                raise
            LOG.warning("meta watermark save failed (stale-LOW, "
                        "non-fatal)", exc_info=True)
            try:
                os.remove(self._wm_path() + ".tmp")
            except OSError:
                pass

    # graftcheck: allow(guarded-by) — construction-time: runs inside __init__, before the journal is shared
    def _open(self) -> None:
        wm = self._load_wm()
        exists = os.path.exists(self._path())
        self._f = open(self._path(), "r+b" if exists else "w+b")
        blob = self._f.read()
        off, good = 0, 0
        while off + _HDR.size <= len(blob):
            try:
                (glen,) = _HDR.unpack_from(blob, off)
                p = off + _HDR.size
                group = blob[p:p + glen]
                p += glen
                (term,) = _TERM.unpack_from(blob, p)
                p += _TERM.size
                (vlen,) = _HDR.unpack_from(blob, p)
                p += _HDR.size
                voted = blob[p:p + vlen]
                p += vlen
                (crc,) = _CRC.unpack_from(blob, p)
                p += _CRC.size
                if len(group) != glen or len(voted) != vlen \
                        or zlib.crc32(blob[off:p - _CRC.size]) != crc:
                    raise ValueError("bad record")
            except (struct.error, ValueError):
                if off < wm:
                    raise CorruptLogError(
                        f"{self._path()}: record at offset {off} inside "
                        f"the durable region (<{wm}) fails scan — an "
                        f"acked {{term, votedFor}} may be lost; refusing "
                        f"to truncate (double-vote hazard)")
                break  # torn tail: that save was never acked
            self._values[group] = (term, voted)
            off = p
            good = off
        if good < wm:
            raise CorruptLogError(
                f"{self._path()}: durable region ran to {wm} bytes but "
                f"only {good} scan clean — acked meta lost")
        if good < len(blob):
            self._f.truncate(good)
        self._size = good
        # surviving bytes may still be page-cache-dirty (crash-restart):
        # prove them before claiming them durable
        self._f.flush()
        os.fsync(self._f.fileno())
        self._synced = good
        self._save_wm(sync=False)

    # -- staging + group commit ----------------------------------------------

    def stage(self, group: str, term: int, voted: PeerId) -> None:
        g = group.encode()
        v = b"" if voted.is_empty() else str(voted).encode()
        rec = _record(g, term, v)
        with self._lock:
            if self._f is None:
                raise IOError("meta journal closed")
            self._f.seek(self._size)
            self._f.write(rec)
            self._size += len(rec)
            self._values[g] = (term, v)
            self.save_count += 1

    def sync(self) -> None:
        """One fsync round (called by _GroupCommit, possibly from an
        executor thread); compacts when garbage dominates.

        The fsync runs OUTSIDE the staging lock: stage() is called
        inline on the event loop (save_async), and holding that lock
        through a writeback-stalled fsync would stall the loop —
        heartbeats for every group in the process — exactly what the
        group-commit machinery exists to prevent.  ``_sync_lock`` is
        held for the whole round instead, so a concurrent round (the
        synchronous ``_save`` path racing a group-commit round) cannot
        interleave with compaction closing the handle mid-fsync.  Only
        bytes staged BEFORE this flush are claimed synced."""
        with self._sync_lock:
            with self._lock:
                if self._f is None:
                    raise IOError("meta journal closed")
                f = self._f
                f.flush()
                size = self._size
            try:
                os.fsync(f.fileno())
            except ValueError:
                # unreachable while _sync_lock serializes close() and
                # compaction; kept as a defensive remap
                raise IOError("meta journal closed")
            with self._lock:
                self.sync_count += 1
                if self._f is f and size > self._synced:
                    self._synced = size
                live = max(1, len(self._values))
                if (self._f is f and size >= self.COMPACT_MIN_BYTES
                        and self._size > 8 * live * 64):
                    # compaction stays under both locks (it swaps the
                    # file handle out from under stagers and fsyncers):
                    # rare — threshold-gated — and bounded by the live
                    # set's size, unlike the per-round fsync above
                    try:
                        self._compact_locked()
                    except OSError:
                        # compaction is an optimization: a rewrite that
                        # dies ENOSPC (tmp copy on a full disk) must not
                        # fail the sync round that already fsynced — the
                        # journal handle and staged bytes are untouched
                        # (os.replace either never ran or landed whole).
                        # Drop the partial tmp; a later round retries.
                        try:
                            os.remove(self._path() + ".tmp")
                        except OSError:
                            pass

    def _compact_locked(self) -> None:
        # floor the watermark (fsynced) BEFORE replacing the file: if the
        # rename lands and a higher watermark write doesn't, boot would
        # demand old-size bytes from the new, smaller file
        self._synced = 0
        self._save_wm(sync=True)
        tmp = self._path() + ".tmp"
        with open(tmp, "wb") as f:
            for g, (term, v) in self._values.items():
                f.write(_record(g, term, v))
            f.flush()
            os.fsync(f.fileno())
            new_size = f.tell()
        os.replace(tmp, self._path())
        _fsync_dir(self.dir)
        self._f.close()
        self._f = open(self._path(), "r+b")
        self._size = new_size
        self._synced = new_size
        self._save_wm(sync=False)  # stale-LOW safe

    # -- per-group access ----------------------------------------------------

    def get(self, group: str) -> tuple[int, PeerId]:
        with self._lock:
            term, v = self._values.get(group.encode(), (0, b""))
        return term, (PeerId.parse(v.decode()) if v else EMPTY_PEER)

    def close(self) -> None:
        # _sync_lock first: an in-flight sync round must finish its
        # fsync before the handle disappears (same discipline as
        # MultiLogEngine.close vs its sync lock)
        with self._sync_lock, self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                    self._synced = self._size
                    self._save_wm(sync=False)
                finally:
                    self._f.close()
                    self._f = None


# -- process-level registry (one journal per directory), like multilog -------

_journals_lock = threading.Lock()
_journals: dict[str, MetaJournal] = {}  # guarded-by: _journals_lock


def get_journal(dir_path: str) -> MetaJournal:
    key = os.path.realpath(dir_path)
    with _journals_lock:
        j = _journals.get(key)
        if j is None or j._f is None:
            j = MetaJournal(dir_path)
            _journals[key] = j
        j._refs += 1
        return j


def _release_journal(j: MetaJournal) -> None:
    key = os.path.realpath(j.dir)
    with _journals_lock:
        j._refs -= 1
        if j._refs > 0:
            return
        _journals.pop(key, None)
        # close INSIDE the registry lock: a concurrent get_journal on
        # the same directory must not reopen (and possibly truncate a
        # torn tail + lower the watermark) while this handle is still
        # flushing — the final flush here could otherwise re-persist a
        # higher watermark than the new handle's truncated size, a
        # false CorruptLogError at the next boot
        j.close()


class MultiRaftMetaStorage(RaftMetaStorage):
    """Per-group facade over the shared :class:`MetaJournal`.

    Implements the synchronous ``RaftMetaStorage`` interface (each save
    = stage + engine fsync) plus ``save_async`` — stage inline, then join
    the shared group-commit round so concurrent groups' meta persists
    cost one fsync.  ``Node._persist_meta`` prefers ``save_async``.
    """

    def __init__(self, dir_path: str, group: str):
        super().__init__(dir_path, sync=True)
        self._group = group
        self._jnl: Optional[MetaJournal] = None

    def init(self) -> None:
        self._jnl = get_journal(self._dir)
        self.term, self.voted_for = self._jnl.get(self._group)

    def _save(self, term: int, voted_for: PeerId) -> None:
        assert self._jnl is not None, "init() first"
        self._jnl.stage(self._group, term, voted_for)
        self._jnl.sync()

    async def save_async(self, term: int, voted_for: PeerId) -> None:
        assert self._jnl is not None, "init() first"
        self.term = term
        self.voted_for = voted_for
        self._jnl.stage(self._group, term, voted_for)
        await self._jnl.group_commit.flush()

    def shutdown(self) -> None:
        if self._jnl is not None:
            _release_journal(self._jnl)
            self._jnl = None
