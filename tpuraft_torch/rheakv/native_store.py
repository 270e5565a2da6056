"""ctypes bindings for the C++ KV storage engine (native/kvstore.cc).

Reference parity: the JNI seam under ``rhea:storage/RocksRawKVStore`` —
Java orchestrates, RocksDB (C++) owns the bytes (SURVEY.md §3.2/§3.4).
Here the C++ engine owns the ordered tables, WAL durability, CRC
recovery and checkpointing; Python owns op semantics (sequences, lock
leases, CAS) — safe because every mutation arrives through the region
state machine's single apply thread.

Columns: 0=data 1=sequence 2=lock 3=meta (fencing counter).  Snapshot
blobs use the exact MemoryRawKVStore format so the two engines are
interchangeable across snapshot install.

Build: ``make -C native``; :func:`ensure_built` does it on demand.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import time
from typing import Optional

from tpuraft_torch.rheakv.raw_store import LockOwner, RawKVStore, Sequence

_LIB_NAME = "libtpuraft_kvstore.so"
_COL_DATA, _COL_SEQ, _COL_LOCK, _COL_META = 0, 1, 2, 3
_FENCING_KEY = b"fencing"
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
# lock value: wall deadline (f64), fencing (i64), acquires (u32), locker_id
_LOCK_HDR = struct.Struct("<dqI")
_OP_PUT, _OP_DELETE, _OP_DELETE_RANGE = 1, 2, 3


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


def lib_path() -> str:
    return os.environ.get(
        "TPURAFT_NATIVE_KV_LIB",
        os.path.normpath(os.path.join(_native_dir(), _LIB_NAME)))


def ensure_built(timeout: float = 120.0) -> str:
    from tpuraft_torch.util.native_build import ensure_built as _eb
    return _eb(_native_dir(), lib_path(), timeout=timeout)


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(lib_path())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.tkv_open.restype = ctypes.c_void_p
            lib.tkv_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_char_p,
                                     ctypes.c_int]
            lib.tkv_close.argtypes = [ctypes.c_void_p]
            lib.tkv_free.argtypes = [u8p]
            lib.tkv_apply_batch.restype = ctypes.c_int
            lib.tkv_apply_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_int64, ctypes.c_char_p,
                                            ctypes.c_int]
            lib.tkv_get.restype = ctypes.c_int64
            lib.tkv_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.POINTER(u8p)]
            lib.tkv_scan.restype = ctypes.c_int64
            lib.tkv_scan.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.POINTER(u8p)]
            lib.tkv_count_range.restype = ctypes.c_int64
            lib.tkv_count_range.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_char_p, ctypes.c_int64,
                                            ctypes.c_char_p, ctypes.c_int64]
            lib.tkv_checkpoint.restype = ctypes.c_int
            lib.tkv_checkpoint.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int]
            lib.tkv_wal_bytes.restype = ctypes.c_int64
            lib.tkv_wal_bytes.argtypes = [ctypes.c_void_p]
            lib.tkv_count.restype = ctypes.c_int64
            lib.tkv_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.tkv_open2.restype = ctypes.c_void_p
            lib.tkv_open2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_char_p,
                                      ctypes.c_int]
            for name in ("tkv_run_count", "tkv_mem_bytes",
                         "tkv_compactions",
                         "tkv_compact_input_bytes",
                         "tkv_compact_last_input_bytes",
                         "tkv_data_bytes"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def _encode_ops(ops: list[tuple[int, int, bytes, bytes]]) -> bytes:
    parts = []
    for op, col, key, val in ops:
        parts.append(bytes((op, col)))
        parts.append(_U32.pack(len(key)))
        parts.append(key)
        parts.append(_U32.pack(len(val)))
        parts.append(val)
    return b"".join(parts)


class NativeRawKVStore(RawKVStore):
    """RawKVStore over the C++ engine; selected by ``native://<dir>``."""

    def __init__(self, dir_path: str, sync: bool = True,
                 checkpoint_wal_bytes: int = 0,
                 memtable_budget_bytes: int = 0, max_runs: int = 0):
        """memtable_budget_bytes > 0 enables the LSM tier (the RocksDB
        >RAM role): the memtable spills to immutable sorted runs at the
        budget, background compaction merges runs past ``max_runs``, and
        recovery replays at most one memtable of WAL.  0 keeps the
        bounded-by-RAM memtable+checkpoint engine."""
        self._dir = dir_path
        self._lib = _load()
        err = ctypes.create_string_buffer(256)
        h = self._lib.tkv_open2(dir_path.encode(), 1 if sync else 0,
                                checkpoint_wal_bytes, memtable_budget_bytes,
                                max_runs, err, 256)
        if not h:
            raise IOError(f"native kv open failed: {err.value.decode()}")
        self._h = h

    @property
    def run_count(self) -> int:
        return self._lib.tkv_run_count(self._handle())

    @property
    def mem_bytes(self) -> int:
        return self._lib.tkv_mem_bytes(self._handle())

    @property
    def compactions(self) -> int:
        return self._lib.tkv_compactions(self._handle())

    @property
    def compact_input_bytes(self) -> int:
        """Cumulative compaction input bytes (write amplification)."""
        return self._lib.tkv_compact_input_bytes(self._handle())

    @property
    def compact_last_input_bytes(self) -> int:
        """Input bytes of the latest compaction cycle — with size-tiered
        pick-K this tracks the small spill tier, NOT total store size."""
        return self._lib.tkv_compact_last_input_bytes(self._handle())

    @property
    def data_bytes(self) -> int:
        """On-disk bytes across all run files."""
        return self._lib.tkv_data_bytes(self._handle())

    def close(self) -> None:
        if self._h is not None:
            self._lib.tkv_close(self._h)
            self._h = None

    # -- raw plumbing --------------------------------------------------------

    def _handle(self):
        # raise (don't segfault) on use-after-close, e.g. a straggling
        # read draining during store shutdown; the C side also null-guards
        if self._h is None:
            raise IOError("native kv store is closed")
        return self._h

    def _write(self, ops: list[tuple[int, int, bytes, bytes]]) -> None:
        blob = _encode_ops(ops)
        err = ctypes.create_string_buffer(256)
        if self._lib.tkv_apply_batch(self._handle(), blob, len(blob),
                                     err, 256) != 0:
            raise IOError(f"native kv write failed: {err.value.decode()}")

    def _get(self, col: int, key: bytes) -> Optional[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.tkv_get(self._handle(), col, key, len(key),
                              ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.tkv_free(out)

    def _scan(self, col: int, start: bytes, end: bytes, limit: int,
              with_values: bool, reverse: bool = False
              ) -> list[tuple[bytes, Optional[bytes]]]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.tkv_scan(self._handle(), col, start, len(start), end, len(end),
                               limit, 1 if with_values else 0,
                               1 if reverse else 0, ctypes.byref(out))
        if n < 0:
            raise IOError("native kv scan failed")
        try:
            blob = ctypes.string_at(out, n)
        finally:
            self._lib.tkv_free(out)
        (count,) = _U32.unpack_from(blob, 0)
        off = 4
        rows: list[tuple[bytes, Optional[bytes]]] = []
        for _ in range(count):
            (kl,) = _U32.unpack_from(blob, off)
            off += 4
            k = blob[off:off + kl]
            off += kl
            v = None
            if with_values:
                (vl,) = _U32.unpack_from(blob, off)
                off += 4
                v = blob[off:off + vl]
                off += vl
            rows.append((k, v))
        return rows

    # -- reads ---------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        return self._get(_COL_DATA, key)

    def scan(self, start: bytes, end: bytes, limit: int = -1,
             return_value: bool = True) -> list[tuple[bytes, Optional[bytes]]]:
        return self._scan(_COL_DATA, start, end, limit, return_value)

    def reverse_scan(self, start: bytes, end: bytes, limit: int = -1,
                     return_value: bool = True
                     ) -> list[tuple[bytes, Optional[bytes]]]:
        return self._scan(_COL_DATA, start, end, limit, return_value,
                          reverse=True)

    def approximate_keys_in_range(self, start: bytes, end: bytes) -> int:
        return self._lib.tkv_count_range(self._handle(), _COL_DATA, start,
                                         len(start), end, len(end))

    # -- writes --------------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        self._write([(_OP_PUT, _COL_DATA, key, value)])

    def put_list(self, kvs: list[tuple[bytes, bytes]]) -> None:
        if kvs:
            self._write([(_OP_PUT, _COL_DATA, k, v) for k, v in kvs])

    def delete(self, key: bytes) -> None:
        self._write([(_OP_DELETE, _COL_DATA, key, b"")])

    def delete_list(self, keys: list[bytes]) -> None:
        if keys:
            self._write([(_OP_DELETE, _COL_DATA, k, b"") for k in keys])

    def apply_write_batch(self, ops: list[tuple[bytes, Optional[bytes]]]
                          ) -> None:
        # one ctypes call + one WAL record for the whole mixed run
        if ops:
            self._write([(_OP_PUT, _COL_DATA, k, v) if v is not None
                         else (_OP_DELETE, _COL_DATA, k, b"")
                         for k, v in ops])

    def delete_range(self, start: bytes, end: bytes) -> None:
        self._write([(_OP_DELETE_RANGE, _COL_DATA, start, end)])

    def reset_range(self, start: bytes, end: bytes) -> None:
        # one atomic batch: data, sequences, locks
        self._write([(_OP_DELETE_RANGE, col, start, end)
                     for col in (_COL_DATA, _COL_SEQ, _COL_LOCK)])

    # -- sequences -----------------------------------------------------------

    def get_sequence(self, key: bytes, step: int) -> Sequence:
        raw = self._get(_COL_SEQ, key)
        cur = _I64.unpack(raw)[0] if raw else 0
        if step <= 0:
            return Sequence(cur, cur)
        self._write([(_OP_PUT, _COL_SEQ, key, _I64.pack(cur + step))])
        return Sequence(cur, cur + step)

    def reset_sequence(self, key: bytes) -> None:
        self._write([(_OP_DELETE, _COL_SEQ, key, b"")])

    # -- locks ---------------------------------------------------------------
    # Lease deadlines persist as wall-clock stamps (the engine outlives the
    # process, unlike MemoryRawKVStore's monotonic in-memory deadlines).

    def _load_lock(self, key: bytes) -> Optional[LockOwner]:
        raw = self._get(_COL_LOCK, key)
        if raw is None:
            return None
        deadline, token, acquires = _LOCK_HDR.unpack_from(raw, 0)
        return LockOwner(raw[_LOCK_HDR.size:], deadline, token, acquires)

    def _store_lock(self, key: bytes, o: LockOwner) -> None:
        self._write([(_OP_PUT, _COL_LOCK, key,
                      _LOCK_HDR.pack(o.deadline, o.fencing_token, o.acquires)
                      + o.locker_id)])

    def _next_fencing(self) -> int:
        raw = self._get(_COL_META, _FENCING_KEY)
        token = (_I64.unpack(raw)[0] if raw else 0) + 1
        self._write([(_OP_PUT, _COL_META, _FENCING_KEY, _I64.pack(token))])
        return token

    def try_lock_with(self, key: bytes, locker_id: bytes, lease_ms: int,
                      keep_lease: bool) -> tuple[bool, int, bytes]:
        # graftcheck: allow(raw-clock) — KV lock-lease deadline: process-local TTL, not consensus timing
        now = time.time()
        owner = self._load_lock(key)
        if owner is not None and not owner.expired(now):
            if owner.locker_id == locker_id:
                if keep_lease:
                    owner.deadline = now + lease_ms / 1000.0
                else:
                    owner.acquires += 1
                self._store_lock(key, owner)
                return True, owner.fencing_token, locker_id
            return False, owner.fencing_token, owner.locker_id
        token = self._next_fencing()
        self._store_lock(key, LockOwner(locker_id, now + lease_ms / 1000.0,
                                        token))
        return True, token, locker_id

    def release_lock(self, key: bytes, locker_id: bytes) -> bool:
        owner = self._load_lock(key)
        if owner is None:
            return True
        # graftcheck: allow(raw-clock) — KV lock-lease deadline: process-local TTL, not consensus timing
        if owner.locker_id != locker_id and not owner.expired(time.time()):
            return False
        owner.acquires -= 1
        if owner.acquires <= 0 or owner.locker_id != locker_id:
            self._write([(_OP_DELETE, _COL_LOCK, key, b"")])
        else:
            self._store_lock(key, owner)
        return True

    # -- admin ---------------------------------------------------------------

    def checkpoint(self) -> None:
        """Force a checkpoint + WAL truncation (auto above the WAL
        threshold; exposed for shutdown / tests)."""
        err = ctypes.create_string_buffer(256)
        if self._lib.tkv_checkpoint(self._handle(), err, 256) != 0:
            raise IOError(f"native kv checkpoint failed: {err.value.decode()}")

    def wal_bytes(self) -> int:
        return self._lib.tkv_wal_bytes(self._handle())

    # -- snapshot (MemoryRawKVStore-compatible blob) -------------------------

    def serialize_range(self, start: bytes, end: bytes) -> bytes:
        kvs = self.scan(start, end)
        seqs = [(k, _I64.unpack(v)[0])
                for k, v in self._scan(_COL_SEQ, start, end, -1, True)]
        locks = []
        for k, raw in self._scan(_COL_LOCK, start, end, -1, True):
            deadline, token, acquires = _LOCK_HDR.unpack_from(raw, 0)
            locks.append((k, LockOwner(raw[_LOCK_HDR.size:], deadline, token,
                                       acquires)))
        out = bytearray(struct.pack("<III", len(kvs), len(seqs), len(locks)))
        for k, v in kvs:
            out += _U32.pack(len(k)) + k + _U32.pack(len(v)) + v
        for k, v in seqs:
            out += _U32.pack(len(k)) + k + _I64.pack(v)
        # graftcheck: allow(raw-clock) — lock-lease persisted as REMAINING duration; wall stamps never cross stores
        now = time.time()
        for k, o in locks:
            out += _U32.pack(len(k)) + k
            out += _U32.pack(len(o.locker_id)) + o.locker_id
            out += struct.pack("<dqI", max(0.0, o.deadline - now),
                               o.fencing_token, o.acquires)
        raw = self._get(_COL_META, _FENCING_KEY)
        out += _I64.pack(_I64.unpack(raw)[0] if raw else 0)
        return bytes(out)

    def load_serialized(self, blob: bytes) -> None:
        buf = memoryview(blob)
        nkv, nseq, nlock = struct.unpack_from("<III", buf, 0)
        off = 12
        ops: list[tuple[int, int, bytes, bytes]] = []
        for _ in range(nkv):
            (kl,) = _U32.unpack_from(buf, off)
            off += 4
            k = bytes(buf[off:off + kl])
            off += kl
            (vl,) = _U32.unpack_from(buf, off)
            off += 4
            ops.append((_OP_PUT, _COL_DATA, k, bytes(buf[off:off + vl])))
            off += vl
        for _ in range(nseq):
            (kl,) = _U32.unpack_from(buf, off)
            off += 4
            k = bytes(buf[off:off + kl])
            off += kl
            (v,) = _I64.unpack_from(buf, off)
            off += 8
            ops.append((_OP_PUT, _COL_SEQ, k, _I64.pack(v)))
        # graftcheck: allow(raw-clock) — lock-lease persisted as REMAINING duration; wall stamps never cross stores
        now = time.time()
        max_token = 0
        for _ in range(nlock):
            (kl,) = _U32.unpack_from(buf, off)
            off += 4
            k = bytes(buf[off:off + kl])
            off += kl
            (ll,) = _U32.unpack_from(buf, off)
            off += 4
            lid = bytes(buf[off:off + ll])
            off += ll
            remain, token, acquires = struct.unpack_from("<dqI", buf, off)
            off += 20
            ops.append((_OP_PUT, _COL_LOCK, k,
                        _LOCK_HDR.pack(now + remain, token, acquires) + lid))
            max_token = max(max_token, token)
        (fencing,) = _I64.unpack_from(buf, off)
        raw = self._get(_COL_META, _FENCING_KEY)
        cur = _I64.unpack(raw)[0] if raw else 0
        fencing = max(cur, fencing, max_token)
        if fencing > cur:
            ops.append((_OP_PUT, _COL_META, _FENCING_KEY, _I64.pack(fencing)))
        if ops:
            self._write(ops)


def create_raw_kv_store(uri: str) -> RawKVStore:
    """SPI-style factory by URI scheme (same seam as create_log_storage)."""
    from tpuraft_torch.rheakv.raw_store import MemoryRawKVStore

    if uri == "memory://":
        return MemoryRawKVStore()
    if uri.startswith("native://"):
        ensure_built()
        return NativeRawKVStore(uri[len("native://"):])
    raise ValueError(f"unknown raw kv store uri: {uri}")
