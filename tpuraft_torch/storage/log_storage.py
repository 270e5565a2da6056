"""Durable raft log storage.

Reference parity: ``core:storage/LogStorage`` interface and
``core:storage/impl/RocksDBLogStorage`` (SURVEY.md §3.1 "Log storage").
Where the reference keys RocksDB by 8-byte big-endian index, this build
uses a *segmented append log* purpose-built for raft's access pattern
(append-mostly, contiguous reads, prefix/suffix truncation) — the same
format the native C++ engine (native/logstore.cc) implements, selected by
``log_uri`` scheme:

  memory://            in-memory (tests, benchmarks)
  file://<dir>         Python segmented log (this module)
  native://<dir>       C++ engine via ctypes (tpuraft.storage.native_log)

On-disk format per segment ``seg_<first_index>.log``:
  repeated [ u32 frame_len | LogEntry.encode() bytes ]  (CRC inside entry)
A tiny ``meta`` file persists first_log_index for prefix truncation.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from abc import ABC, abstractmethod
from typing import Optional

from tpuraft_torch.entity import EntryType, LogEntry

LOG = logging.getLogger(__name__)

_FRAME = struct.Struct("<I")
# durable_end sentinel: "this whole segment was complete at watermark time"
_DURABLE_ALL = 1 << 62


class CorruptLogError(Exception):
    """Mid-log corruption (valid entries beyond a bad frame).

    Distinct from a torn tail: truncating here would silently drop
    acked suffix entries, so startup fails loudly instead.
    """


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames/creations inside it survive power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_crc_watermark(path: str, dir_path: str, vals: bytes,
                       sync: bool) -> None:
    """Write a durability watermark as [values | crc32(values)] via
    tmp + atomic rename (fsynced only when ``sync``— stale-LOW is
    always safe, so the ordinary save skips the fsync)."""
    blob = vals + struct.pack("<I", zlib.crc32(vals))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        if sync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if sync:
        _fsync_dir(dir_path)


def load_crc_watermark(path: str, value_size: int) -> Optional[bytes]:
    """CRC-guarded watermark read: the ordinary save is NOT fsynced, so
    after a power loss the file can hold garbage — and a garbage
    watermark read as trusted would brick a healthy store with a false
    CorruptLogError.  Returns the raw value bytes ONLY for an exact
    [values | crc32(values)] record; anything else — absent, wrong
    size (pre-CRC legacy files and prefix-torn records included), or a
    CRC mismatch — returns None and the caller degrades to its
    nothing-proven sentinel, which always falls back to safe torn-tail
    semantics.  Trusting bare value_size-byte content was considered
    and rejected: partial-page writeback can leave right-sized GARBAGE
    (a torn CRC record with flipped bytes), and a garbage-high value
    bricks recovery; degrading a legacy watermark once costs only one
    boot's fail-loud coverage."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return None
    if len(blob) != value_size + 4:
        return None
    (crc,) = struct.unpack_from("<I", blob, value_size)
    if zlib.crc32(blob[:value_size]) == crc:
        return blob[:value_size]
    return None


class LogStorage(ABC):
    """Synchronous storage SPI; LogManager wraps it with async batching."""

    @abstractmethod
    def init(self) -> None: ...

    @abstractmethod
    def shutdown(self) -> None: ...

    @abstractmethod
    def first_log_index(self) -> int: ...

    @abstractmethod
    def last_log_index(self) -> int: ...

    @abstractmethod
    def get_entry(self, index: int) -> Optional[LogEntry]: ...

    def get_term(self, index: int) -> int:
        e = self.get_entry(index)
        return e.id.term if e else 0

    @abstractmethod
    def append_entries(self, entries: list[LogEntry], sync: bool = True) -> int:
        """Append a batch; returns count appended."""

    @abstractmethod
    def truncate_prefix(self, first_index_kept: int) -> None:
        """Drop entries < first_index_kept (snapshot compaction)."""

    @abstractmethod
    def truncate_suffix(self, last_index_kept: int) -> None:
        """Drop entries > last_index_kept (conflict resolution)."""

    @abstractmethod
    def reset(self, next_log_index: int) -> None:
        """Drop everything; next append starts at next_log_index
        (InstallSnapshot beyond local log)."""

    def configuration_indexes(self) -> list[int]:
        """Indexes of CONFIGURATION entries currently stored — lets the
        LogManager rebuild configuration history without an O(n) scan
        (the reference keeps conf entries in their own column family)."""
        return [
            i
            for i in range(self.first_log_index(), self.last_log_index() + 1)
            if (e := self.get_entry(i)) and e.type == EntryType.CONFIGURATION
        ]


class MemoryLogStorage(LogStorage):
    """Reference test double (``MemoryLogStorage`` exists upstream too)."""

    CHEAP_CONF_INDEXES = True  # dict walk, no disk

    def __init__(self) -> None:
        self._entries: dict[int, LogEntry] = {}
        self._first = 1
        self._last = 0

    def init(self) -> None:
        pass

    def shutdown(self) -> None:
        self._entries.clear()

    def first_log_index(self) -> int:
        return self._first

    def last_log_index(self) -> int:
        return self._last

    def get_entry(self, index: int) -> Optional[LogEntry]:
        return self._entries.get(index)

    def append_entries(self, entries: list[LogEntry], sync: bool = True) -> int:
        for e in entries:
            self._entries[e.id.index] = e
            self._last = max(self._last, e.id.index)
        return len(entries)

    def truncate_prefix(self, first_index_kept: int) -> None:
        for i in range(self._first, first_index_kept):
            self._entries.pop(i, None)
        self._first = max(self._first, first_index_kept)
        if self._last < self._first - 1:
            self._last = self._first - 1

    def truncate_suffix(self, last_index_kept: int) -> None:
        for i in range(last_index_kept + 1, self._last + 1):
            self._entries.pop(i, None)
        self._last = min(self._last, last_index_kept)

    def reset(self, next_log_index: int) -> None:
        self._entries.clear()
        self._first = next_log_index
        self._last = next_log_index - 1


class _Segment:
    """One append-only segment file with an in-memory offset index."""

    def __init__(self, path: str, first_index: int):
        self.path = path
        self.first_index = first_index
        self.offsets: list[int] = []  # offsets[i] = file offset of entry first_index+i
        self.size = 0
        self._f = None  # type: ignore[assignment]

    @property
    def last_index(self) -> int:
        return self.first_index + len(self.offsets) - 1

    def open(self, durable_end: int = 0) -> None:
        exists = os.path.exists(self.path)
        self._f = open(self.path, "r+b" if exists else "w+b")
        if exists:
            self._scan(durable_end)

    def _scan(self, durable_end: int) -> None:
        """Rebuild the offset index; truncate a torn tail write if found.

        ``durable_end``: bytes below it were verified present at an
        earlier startup (the store's ``synced`` watermark).  A failure
        BELOW it can't be a torn in-flight write — it is corruption of
        previously-durable (acked, possibly committed) data, and
        truncating there would silently drop the log suffix, so fail
        loudly and let the operator rebuild the replica from a
        snapshot.  At/above the watermark nothing was acked against a
        completed fsync, and unordered page writeback can legitimately
        persist a LATER entry's blocks while losing an earlier one's —
        so any failure there is a truncatable torn tail, valid-looking
        bytes after it notwithstanding.
        """
        f = self._f
        f.seek(0, os.SEEK_END)
        end = f.tell()
        f.seek(0)
        off = 0
        good_end = 0
        while off + _FRAME.size <= end:
            f.seek(off)
            (flen,) = _FRAME.unpack(f.read(_FRAME.size))
            if off + _FRAME.size + flen > end:
                if off < durable_end:
                    raise CorruptLogError(
                        f"{self.path}: frame at offset {off} overruns the "
                        f"file inside the durable region (<{durable_end}) — "
                        f"refusing to truncate acked suffix")
                break  # torn write
            blob = f.read(flen)
            try:
                LogEntry.decode(blob)  # CRC + framing check
            except (ValueError, struct.error):
                if off < durable_end:
                    raise CorruptLogError(
                        f"{self.path}: CRC/framing failure at offset {off} "
                        f"inside the durable region (<{durable_end}) — "
                        f"refusing to truncate acked suffix")
                break
            self.offsets.append(off)
            off += _FRAME.size + flen
            good_end = off
        if durable_end >= _DURABLE_ALL:
            # fully-durable segment (strictly below the watermark
            # segment): its exact size wasn't recorded, so the most we
            # can demand is that every byte present scans clean
            bad = good_end < end
        else:
            # watermark segment: at least the recorded size must scan
            # clean — catches clean-at-a-frame-boundary shrinkage too
            # (no bad frame to trip on, the file just ends early)
            bad = good_end < durable_end
        if bad:
            raise CorruptLogError(
                f"{self.path}: durable region ran to "
                f"{min(durable_end, end)} bytes but only {good_end} scan "
                f"clean — acked entries lost")
        if good_end < end:
            f.truncate(good_end)
        self.size = good_end

    def append(self, blob: bytes) -> None:
        self._f.seek(self.size)
        self._f.write(_FRAME.pack(len(blob)))
        self._f.write(blob)
        self.offsets.append(self.size)
        self.size += _FRAME.size + len(blob)

    def read(self, index: int) -> LogEntry:
        off = self.offsets[index - self.first_index]
        self._f.seek(off)
        (flen,) = _FRAME.unpack(self._f.read(_FRAME.size))
        return LogEntry.decode(self._f.read(flen))

    def truncate_to(self, last_index_kept: int) -> None:
        n_keep = last_index_kept - self.first_index + 1
        if n_keep >= len(self.offsets):
            return
        new_size = self.offsets[n_keep] if n_keep > 0 else 0
        self._f.truncate(new_size)
        self._f.flush()
        os.fsync(self._f.fileno())
        del self.offsets[n_keep:]
        self.size = new_size

    def sync(self) -> None:
        f = self._f
        if f is None:
            return  # deleted/closed concurrently; its data is gone anyway
        try:
            f.flush()
            os.fsync(f.fileno())
        except ValueError:
            pass  # closed between the check and the flush

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def delete(self) -> None:
        self.close()
        if os.path.exists(self.path):
            os.remove(self.path)


class FileLogStorage(LogStorage):
    """Segmented append-log storage (Python implementation)."""

    SEGMENT_MAX_BYTES = 64 * 1024 * 1024

    def __init__(self, dir_path: str, segment_max_bytes: int | None = None):
        self._dir = dir_path
        self._segments: list[_Segment] = []     # guarded-by: _lock
        self._first = 1                         # guarded-by: _lock
        self._seg_max = segment_max_bytes or self.SEGMENT_MAX_BYTES
        self._conf_indexes: list[int] = []      # guarded-by: _lock
        # synced frontier (active_segment_first_index, size): the bytes
        # PROVEN on disk by a completed fsync.  The persisted watermark
        # (`synced` file) only ever records this value, so it can never
        # run ahead of durability (stale-HIGH), which would turn a
        # legitimate torn tail into a false CorruptLogError.
        self._synced = (-1, 0)                  # guarded-by: _lock
        # guards _segments and file handles: the event loop reads (get_entry)
        # while the LogManager flusher appends/truncates in executor threads
        self._lock = threading.RLock()

    # -- lifecycle ----------------------------------------------------------

    # graftcheck: allow(guarded-by) — init-time: the LogManager flusher that shares these fields does not exist yet
    def init(self) -> None:
        os.makedirs(self._dir, exist_ok=True)
        self._load_meta()
        wm_first, wm_size = self._load_watermark()
        names = sorted(
            (n for n in os.listdir(self._dir) if n.startswith("seg_") and n.endswith(".log")),
            key=lambda n: int(n[4:-4]),
        )
        on_disk_firsts = [int(n[4:-4]) for n in names]
        # Segments provably compacted garbage from names alone: a
        # below-first segment ends strictly before the next on-disk
        # segment's first index, so ANY on-disk successor starting in
        # (its_first, first_log_index] proves its whole range is below
        # first_log_index — leftovers of a crash mid truncate_prefix.
        # Scan those tolerantly (durable_end=0): demanding durable-
        # region cleanliness of about-to-be-deleted garbage would brick
        # boot on a torn (or rotted) tail that never mattered.
        stale_certain = {
            fi for fi in on_disk_firsts if fi < self._first and any(
                fi < nx <= self._first for nx in on_disk_firsts)}
        wm_seg_verified_stale = False
        drop_rest = False
        for n in names:
            first_index = int(n[4:-4])
            # durable region (see _Segment._scan): segments strictly
            # below the watermark segment were complete when the
            # watermark was recorded; the watermark segment is durable
            # up to the recorded size; later segments not at all
            if first_index in stale_certain:
                durable_end = 0
            elif first_index < wm_first:
                durable_end = _DURABLE_ALL
            elif first_index == wm_first:
                durable_end = wm_size
            else:
                durable_end = 0
            seg = _Segment(os.path.join(self._dir, n), first_index)
            seg.open(durable_end)
            # stale: fully below first_log_index — crash mid truncate_prefix
            # (meta saved, file not yet deleted)
            stale = seg.first_index < self._first and (
                not seg.offsets or seg.last_index < self._first
            )
            if drop_rest or stale:
                if stale and first_index == wm_first \
                        and first_index not in stale_certain:
                    # the watermark segment scanned clean at its recorded
                    # durable size and is entirely below first_log_index:
                    # provably compacted, nothing acked lost
                    wm_seg_verified_stale = True
                seg.delete()
                continue
            if not seg.offsets or (
                self._segments
                and seg.first_index != self._segments[-1].last_index + 1
            ):
                # empty (torn) segment or a hole from a torn multi-segment
                # batch append: everything from here on is unreachable.
                # But a hole or vanished bytes in the DURABLE region is
                # the fail-loud case — deleting would silently drop the
                # acked suffix just like a silent truncation would.
                expected = (self._segments[-1].last_index + 1
                            if self._segments else self._first)
                if durable_end > 0 or expected < wm_first:
                    raise CorruptLogError(
                        f"{self._dir}: durable segment(s) missing or empty "
                        f"around index {expected} (watermark segment "
                        f"{wm_first}) — refusing to drop acked suffix")
                seg.delete()
                drop_rest = True
                continue
            self._segments.append(seg)
        if wm_size > 0 and not any(s.first_index == wm_first
                                   for s in self._segments):
            # The watermark segment itself vanished with recorded bytes
            # in it.  One legitimate cause: prefix compaction deleted it
            # (truncate_prefix only removes segments ENTIRELY below
            # first_log_index, and a crash between _save_meta and the
            # segment deletes leaves the same state via init's stale
            # cleanup above).  That case is provable from what WAS on
            # disk at boot: some segment started in (wm_first, _first],
            # so the watermark segment ended strictly below _first —
            # every index it held is compacted, nothing acked is lost.
            # Anything else (segment straddling _first gone, or no
            # bounding successor) is external loss: fail loudly.
            compacted = wm_seg_verified_stale or (
                wm_first < self._first and any(
                    wm_first < fi <= self._first for fi in on_disk_firsts))
            if not compacted:
                raise CorruptLogError(
                    f"{self._dir}: watermark segment seg_{wm_first}.log "
                    f"({wm_size} durable bytes) is missing — acked entries "
                    f"lost")
        self._load_conf_indexes()
        # Bytes at/above the loaded watermark are readable but possibly
        # still dirty in the page cache (crash-restart case): fsync them
        # before advancing the watermark over them, or a power loss in
        # the writeback window would turn the watermark into a false
        # corruption alarm at the NEXT boot.  Bytes below it were
        # fsynced before that watermark was recorded — skip (O(1)
        # fsyncs at boot, not O(#segments)).
        for seg in self._segments:
            if seg.first_index >= wm_first:
                seg.sync()
        if self._segments:
            last = self._segments[-1]
            self._synced = (last.first_index, last.size)
        else:
            self._synced = (-1, 0)
        self._save_watermark()

    def shutdown(self) -> None:
        # clean shutdown: fsync + advance the watermark over everything
        # written this run, so the next scan treats it all as durable.
        # Everything at/above the synced frontier may be dirty (rolled
        # segments in a sync=False run included) — flush it all.
        # Under _lock: a snapshot compaction still running in an
        # executor thread (truncate_prefix) mutates _segments, and the
        # unguarded walk raced it into an IndexError mid-shutdown.
        with self._lock:
            if self._segments:
                for s in self._segments:
                    if s.first_index >= self._synced[0]:
                        s.sync()
                last = self._segments[-1]
                self._synced = (last.first_index, last.size)
                self._save_watermark()
            for s in self._segments:
                s.close()
            self._segments.clear()

    # -- durability watermark ------------------------------------------------
    # Persists the synced frontier (active_segment_first_index, size) —
    # recorded at init (after scan + fsync), clean shutdown, and around
    # destructive ops; never on the append hot path.  Stale-LOW is
    # always safe (falls back to torn-tail truncation semantics), so the
    # ordinary save is not fsynced.  Destructive ops (suffix truncation,
    # reset) FIRST persist a lowered floor WITH fsync: the reverse order
    # would leave a stale-HIGH watermark if the shrink hit disk and the
    # lowered watermark didn't, bricking startup with a false
    # CorruptLogError.

    def _watermark_path(self) -> str:
        return os.path.join(self._dir, "synced")

    def _load_watermark(self) -> tuple[int, int]:  # graftcheck: holds(_lock)
        # CRC-guarded (see load_crc_watermark): garbage degrades to
        # (-1, 0) = nothing provably durable, which is always safe
        vals = load_crc_watermark(self._watermark_path(), 16)
        if vals is None:
            return (-1, 0)
        return struct.unpack("<qq", vals)

    def _save_watermark(self, sync: bool = False) -> None:  # graftcheck: holds(_lock)
        try:
            save_crc_watermark(self._watermark_path(), self._dir,
                               struct.pack("<qq", *self._synced), sync)
        except OSError:
            # sync=True saves are the destructive-op FLOORS (prefix/
            # suffix truncation, reset): a floor that can't be
            # persisted must abort its operation, so propagate.
            if sync:
                raise
            # every non-sync save ADVANCES the watermark after the
            # fact (init scan, clean shutdown, post-truncation
            # refresh), and stale-LOW is always safe — a full disk
            # (ENOSPC on synced.tmp) must not fail boot or shutdown
            # over a scan-avoidance optimization
            LOG.warning("watermark save failed (stale-LOW, non-fatal)",
                        exc_info=True)
            try:
                os.remove(self._watermark_path() + ".tmp")
            except OSError:
                pass

    def _meta_path(self) -> str:
        return os.path.join(self._dir, "meta")

    def _load_meta(self) -> None:  # graftcheck: holds(_lock)
        try:
            with open(self._meta_path(), "rb") as f:
                self._first = struct.unpack("<q", f.read(8))[0]
        except FileNotFoundError:
            self._first = 1

    def _save_meta(self) -> None:  # graftcheck: holds(_lock)
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<q", self._first))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path())
        _fsync_dir(self._dir)

    # conf sidecar: indexes of CONFIGURATION entries, so LogManager init
    # avoids an O(n) scan (reference: RocksDB conf column family)

    def _conf_path(self) -> str:
        return os.path.join(self._dir, "conf.idx")

    def _load_conf_indexes(self) -> None:  # graftcheck: holds(_lock)
        self._conf_indexes = []
        try:
            with open(self._conf_path(), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return
        n = len(blob) // 8
        first, last = self._first, self.last_log_index()
        self._conf_indexes = [
            i
            for (i,) in struct.iter_unpack("<q", blob[: n * 8])
            if first <= i <= last
        ]

    def _rewrite_conf_indexes(self) -> None:  # graftcheck: holds(_lock)
        tmp = self._conf_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"".join(struct.pack("<q", i) for i in self._conf_indexes))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._conf_path())
        _fsync_dir(self._dir)

    def configuration_indexes(self) -> list[int]:
        with self._lock:
            return list(self._conf_indexes)

    # -- queries ------------------------------------------------------------

    def first_log_index(self) -> int:
        with self._lock:
            return self._first

    def last_log_index(self) -> int:
        with self._lock:
            if not self._segments:
                return self._first - 1
            return self._segments[-1].last_index

    def _find_segment(self, index: int) -> Optional[_Segment]:  # graftcheck: holds(_lock)
        lo, hi = 0, len(self._segments) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            s = self._segments[mid]
            if index < s.first_index:
                hi = mid - 1
            elif index > s.last_index:
                lo = mid + 1
            else:
                return s
        return None

    def get_entry(self, index: int) -> Optional[LogEntry]:
        with self._lock:
            if index < self._first:
                return None
            s = self._find_segment(index)
            return s.read(index) if s else None

    # -- mutations ----------------------------------------------------------

    def append_entries(self, entries: list[LogEntry], sync: bool = True) -> int:
        if not entries:
            return 0
        # The WHOLE mutation must hold the lock: this runs in executor
        # threads while the event loop reads get_entry on the same
        # segment file objects — an unlocked seek+write interleaving a
        # locked seek+read corrupts the read (and a misaligned frame can
        # silently return the WRONG entry to a replicator).  The fsync
        # happens OUTSIDE the lock (position-independent), so event-loop
        # readers never stall behind a disk flush.
        with self._lock:
            touched = self._append_entries_locked(entries, sync)
            if touched:
                # frontier candidate captured under the lock: only bytes
                # written BEFORE our fsync below may be claimed synced
                frontier = (touched[-1].first_index, touched[-1].size)
                # prefix durability: segments between the synced
                # frontier and this batch can carry staged-unsynced
                # bytes this batch never touched (an ENOSPC-failed
                # batch's landed prefix, with the segment rolled since).
                # Advancing the watermark over them without an fsync
                # would claim them durable — a crash then drops them,
                # leaving the acked suffix stranded past a hole.
                touched = [s for s in self._segments
                           if (s.first_index, s.size) > self._synced]
        # fsync oldest-first so a crash leaves a prefix, never a hole
        for seg in touched:
            seg.sync()
        if touched:
            with self._lock:
                if frontier > self._synced:
                    self._synced = frontier
        return len(entries)

    def _append_entries_locked(self, entries: list[LogEntry],
                               sync: bool) -> list["_Segment"]:
        expected = self.last_log_index() + 1
        if entries[0].id.index != expected:
            raise ValueError(
                f"non-contiguous append: have last={expected - 1}, got {entries[0].id.index}"
            )
        touched: list[_Segment] = []
        new_conf = False
        for e in entries:
            if not self._segments or self._segments[-1].size >= self._seg_max:
                seg = _Segment(
                    os.path.join(self._dir, f"seg_{e.id.index}.log"), e.id.index
                )
                seg.open()
                _fsync_dir(self._dir)
                self._segments.append(seg)
            cur = self._segments[-1]
            cur.append(e.encode())
            if not touched or touched[-1] is not cur:
                touched.append(cur)
            if e.type == EntryType.CONFIGURATION:
                self._conf_indexes.append(e.id.index)
                new_conf = True
        if new_conf:
            # sidecar BEFORE the entry fsync: a crash in between leaves a
            # sidecar index beyond last_log_index, which init's
            # first<=i<=last filter drops; the reverse order would
            # permanently hide a durable CONFIGURATION entry
            self._rewrite_conf_indexes()
        return touched if sync else []

    def truncate_prefix(self, first_index_kept: int) -> None:
        with self._lock:
            self._truncate_prefix_locked(first_index_kept)

    def _truncate_prefix_locked(self, first_index_kept: int) -> None:
        if first_index_kept <= self._first:
            return
        self._first = first_index_kept
        self._save_meta()
        if any(s.last_index < first_index_kept for s in self._segments):
            # The persisted watermark is only rewritten at init/shutdown/
            # destructive ops, so it can still name a segment this
            # compaction is about to delete (arbitrarily stale-low).
            # Persist the LIVE frontier — fsynced — BEFORE deleting:
            # otherwise a crash after the deletes leaves a watermark
            # pointing at a vanished segment, and the next init() raises
            # a false "watermark segment missing / acked entries lost"
            # on a perfectly healthy replica.  If the frontier segment
            # ITSELF sits inside the doomed range, CLEAR the watermark:
            # everything provably durable is being deleted, surviving
            # segments carry no durable claims (the frontier never
            # reached them — e.g. a sync=False run), so (-1, 0) loses
            # nothing — while naming any survivor would claim the
            # never-fsynced segments below it fully durable, and a crash
            # mid-delete would leave one to fail the _DURABLE_ALL scan
            # (the stale-HIGH false brick this function exists to avoid).
            survivor = next((s for s in self._segments
                             if s.last_index >= first_index_kept), None)
            if self._synced != (-1, 0) and (
                    survivor is None
                    or self._synced[0] < survivor.first_index):
                self._synced = (-1, 0)
            self._save_watermark(sync=True)
        # background-safe: delete whole segments strictly below the kept index
        while self._segments and self._segments[0].last_index < first_index_kept:
            self._segments.pop(0).delete()
        if self._conf_indexes and self._conf_indexes[0] < first_index_kept:
            self._conf_indexes = [i for i in self._conf_indexes if i >= first_index_kept]
            self._rewrite_conf_indexes()

    def truncate_suffix(self, last_index_kept: int) -> None:
        with self._lock:
            self._truncate_suffix_locked(last_index_kept)

    def _truncate_suffix_locked(self, last_index_kept: int) -> None:
        # find the segment that will remain active and FLOOR the
        # watermark to (its start, 0) — fsynced — BEFORE shrinking any
        # file: if the shrink hits disk and a later watermark write
        # doesn't, a stale-HIGH watermark would turn this legitimate
        # truncation into a false CorruptLogError at the next boot.
        target = next((s for s in reversed(self._segments)
                       if s.first_index <= last_index_kept), None)
        floor = (target.first_index, 0) if target else (-1, 0)
        if floor < self._synced:
            self._synced = floor
            self._save_watermark(sync=True)
        while self._segments and self._segments[-1].first_index > last_index_kept:
            self._segments.pop().delete()
        if self._segments:
            self._segments[-1].truncate_to(last_index_kept)
            # fsync even when truncate_to was a no-op (boundary case):
            # the watermark below claims this segment's bytes durable
            self._segments[-1].sync()
            self._synced = (self._segments[-1].first_index,
                            self._segments[-1].size)
        self._save_watermark()
        if self._conf_indexes and self._conf_indexes[-1] > last_index_kept:
            self._conf_indexes = [i for i in self._conf_indexes if i <= last_index_kept]
            self._rewrite_conf_indexes()

    def reset(self, next_log_index: int) -> None:
        with self._lock:
            self._reset_locked(next_log_index)

    def _reset_locked(self, next_log_index: int) -> None:
        # clear the watermark (fsynced) BEFORE deleting files: a crash
        # mid-delete must not leave a watermark pointing into a
        # partially-removed chain (false corruption alarm on reopen)
        self._synced = (-1, 0)
        self._save_watermark(sync=True)
        for s in self._segments:
            s.delete()
        self._segments.clear()
        self._first = next_log_index
        self._conf_indexes = []
        self._rewrite_conf_indexes()
        self._save_meta()


def _split_seg(rest: str) -> tuple[str, Optional[int]]:
    """Split an optional ``?seg=<bytes>`` suffix off a storage path.

    The suffix caps the segment size — prefix compaction returns disk
    in whole-segment units, so small segments make reclaim prompt
    enough for tight storage budgets (the disk-pressure plane)."""
    if "?seg=" not in rest:
        return rest, None
    path, _, val = rest.rpartition("?seg=")
    return path, int(val)


def create_log_storage(uri: str) -> LogStorage:
    """SPI-style factory by URI scheme (reference: DefaultJRaftServiceFactory
    #createLogStorage via JRaftServiceLoader)."""
    if uri == "memory://":
        return MemoryLogStorage()
    if uri.startswith("file://"):
        path, seg = _split_seg(uri[len("file://"):])
        return FileLogStorage(path, segment_max_bytes=seg)
    if uri.startswith("native://"):
        try:
            from tpuraft_torch.storage.native_log import NativeLogStorage
        except ImportError as exc:
            raise ValueError(
                "native:// log storage requires the C++ engine "
                "(build with `make -C native`); falling back is deliberate "
                f"not automatic: {exc}"
            ) from exc
        path, seg = _split_seg(uri[len("native://"):])
        return NativeLogStorage(path, segment_max_bytes=seg or None)
    if uri.startswith("multilog://"):
        # shared multi-group journal engine: multilog://<dir>#<group_id>
        # — every group of a process shares one engine and one fsync per
        # flush round (tpuraft.storage.multilog)
        rest = uri[len("multilog://"):]
        if "#" not in rest:
            raise ValueError(
                "multilog:// needs a group fragment: multilog://<dir>#<group>")
        dir_path, group = rest.rsplit("#", 1)
        from tpuraft_torch.storage.multilog import MultiLogStorage

        return MultiLogStorage(dir_path, group)
    raise ValueError(f"unknown log storage uri: {uri}")
