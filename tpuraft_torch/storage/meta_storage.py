"""Durable {term, votedFor} — the tiny file raft must fsync before voting.

Reference parity: ``core:storage/impl/LocalRaftMetaStorage`` over
``core:storage/io/ProtoBufFile`` (SURVEY.md §3.1).  Format: fixed little-
endian struct + crc32, written tmp-then-atomic-rename.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

from tpuraft_torch.entity import EMPTY_PEER, PeerId

_FMT = struct.Struct("<qI")  # term, crc of (term||votedFor str)

# Per-target-path write serialization.  A store restart creates a NEW
# RaftMetaStorage over the SAME directory while the old node's last
# save may still be in flight on an executor thread: unserialized, the
# two saves raced on the shared .tmp name (os.replace ->
# FileNotFoundError aborting the voter's RPC handler) and, worse, the
# stale instance's save could land LAST and regress the durable term —
# letting the node double-vote after the next crash.  The regression
# guard reads the CURRENT file under the lock (disk is ground truth:
# the crash-consistency harness legitimately rolls the directory back
# to a durable-only image, which an in-memory registry would fight).
_paths_guard = threading.Lock()
_path_locks: dict[str, threading.Lock] = {}  # guarded-by: _paths_guard


def _path_lock(path: str) -> threading.Lock:
    with _paths_guard:
        lock = _path_locks.get(path)
        if lock is None:
            lock = _path_locks[path] = threading.Lock()
        return lock


class RaftMetaStorage:
    def __init__(self, dir_path: str, sync: bool = True):
        self._dir = dir_path
        self._sync = sync
        self.term = 0
        self.voted_for: PeerId = EMPTY_PEER

    def _path(self) -> str:
        return os.path.join(self._dir, "raft_meta")

    def init(self) -> None:
        os.makedirs(self._dir, exist_ok=True)
        try:
            with open(self._path(), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return
        if len(blob) < _FMT.size:
            raise IOError(f"raft meta truncated in {self._dir}")
        term, crc = _FMT.unpack_from(blob, 0)
        voted = blob[_FMT.size:]
        if zlib.crc32(struct.pack("<q", term) + voted) != crc:
            raise IOError(f"raft meta corrupted in {self._dir}")
        self.term = term
        self.voted_for = PeerId.parse(voted.decode()) if voted else EMPTY_PEER

    def set_term_and_voted_for(self, term: int, voted_for: PeerId) -> None:
        self.term = term
        self.voted_for = voted_for
        # pass the values explicitly: _save may run on an executor thread
        # while the event loop rebinds the mirror fields for a NEWER save
        # — re-reading self.term there could persist a torn pair
        self._save(term, voted_for)

    def set_term(self, term: int) -> None:
        self.set_term_and_voted_for(term, self.voted_for)

    def set_voted_for(self, voted_for: PeerId) -> None:
        self.set_term_and_voted_for(self.term, voted_for)

    @staticmethod
    def _read_durable(path: str) -> tuple[int, str]:
        """Best-effort read of the currently persisted {term, votedFor}
        — (-1, "") when missing/corrupt (a fresh write then proceeds)."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
            term, crc = _FMT.unpack_from(blob, 0)
            voted = blob[_FMT.size:]
            if zlib.crc32(struct.pack("<q", term) + voted) != crc:
                return -1, ""
            return term, voted.decode()
        except (OSError, struct.error, UnicodeDecodeError):
            return -1, ""

    def _save(self, term: int, voted_for: PeerId) -> None:
        voted_s = "" if voted_for.is_empty() else str(voted_for)
        voted = voted_s.encode()
        path = self._path()
        with _path_lock(os.path.abspath(path)):
            cur_term, cur_voted = self._read_durable(path)
            if term < cur_term:
                return  # stale instance's late save: never regress term
            if term == cur_term and cur_voted and voted_s != cur_voted:
                # within one term a persisted vote must never be
                # forgotten or switched (double-vote after a crash)
                return
            crc = zlib.crc32(struct.pack("<q", term) + voted)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_FMT.pack(term, crc) + voted)
                f.flush()
                if self._sync:
                    os.fsync(f.fileno())
            os.replace(tmp, path)
            if self._sync:
                fd = os.open(self._dir, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)

    def shutdown(self) -> None:
        pass


class MemoryRaftMetaStorage(RaftMetaStorage):
    """Volatile variant for tests/benchmarks."""

    # _save is a no-op: callers may persist {term, votedFor} inline on
    # the event loop (Node._persist_meta fast path, send-plane inline
    # vote-response handling) instead of paying an executor round
    SYNC_CHEAP = True

    def __init__(self) -> None:
        super().__init__("", sync=False)

    def init(self) -> None:
        pass

    def _save(self, term: int, voted_for: PeerId) -> None:
        pass
