"""ctypes bindings for the C++ log storage engine (native/logstore.cc).

Reference parity: the JNI seam under ``core:storage/impl/RocksDBLogStorage``
— Java orchestrates, C++ owns the bytes (SURVEY.md §3.4).  Here Python
encodes/decodes :class:`LogEntry` (one codec shared with FileLogStorage)
and the C++ engine owns segments, recovery scan, CRC verification, fsync
batching and truncation.  Same on-disk format as FileLogStorage — the two
are interchangeable on one directory.

Build: ``make -C native`` (g++ + zlib only).  :func:`ensure_built` does it
on demand for tests/dev.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Optional

from tpuraft_torch.entity import LogEntry
from tpuraft_torch.storage.log_storage import LogStorage

_FRAME = struct.Struct("<I")
_LIB_NAME = "libtpuraft_logstore.so"


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


def lib_path() -> str:
    return os.environ.get(
        "TPURAFT_NATIVE_LIB", os.path.join(_native_dir(), _LIB_NAME))


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
            lib.tls_open.restype = ctypes.c_void_p
            lib.tls_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int]
            lib.tls_close.argtypes = [ctypes.c_void_p]
            lib.tls_first_index.restype = ctypes.c_int64
            lib.tls_first_index.argtypes = [ctypes.c_void_p]
            lib.tls_last_index.restype = ctypes.c_int64
            lib.tls_last_index.argtypes = [ctypes.c_void_p]
            lib.tls_get.restype = ctypes.c_int64
            lib.tls_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.POINTER(u8p)]
            lib.tls_free.argtypes = [u8p]
            lib.tls_append.restype = ctypes.c_int64
            lib.tls_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int]
            lib.tls_truncate_prefix.restype = ctypes.c_int
            lib.tls_truncate_prefix.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.tls_truncate_suffix.restype = ctypes.c_int
            lib.tls_truncate_suffix.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.tls_reset.restype = ctypes.c_int
            lib.tls_reset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.tls_conf_count.restype = ctypes.c_int64
            lib.tls_conf_count.argtypes = [ctypes.c_void_p]
            lib.tls_conf_indexes.restype = ctypes.c_int64
            lib.tls_conf_indexes.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64]
            _lib = lib
        return _lib


class NativeLogStorage(LogStorage):
    """LogStorage over the C++ engine; selected by ``native://<dir>``."""

    def __init__(self, dir_path: str, segment_max_bytes: int | None = None):
        self._dir = dir_path
        self._seg_max = segment_max_bytes or 0  # 0 -> engine default (64MB)
        self._h: Optional[int] = None
        self._lib = _load()

    def init(self) -> None:
        # the C engine mkdirs only the leaf; create parents here so the
        # scheme doesn't depend on a sibling store initializing first
        parent = os.path.dirname(self._dir.rstrip("/"))
        if parent:
            os.makedirs(parent, exist_ok=True)
        err = ctypes.create_string_buffer(256)
        h = self._lib.tls_open(self._dir.encode(), self._seg_max, err, 256)
        if not h:
            raise IOError(f"native log open failed: {err.value.decode()}")
        self._h = h

    def shutdown(self) -> None:
        if self._h is not None:
            self._lib.tls_close(self._h)
            self._h = None

    def first_log_index(self) -> int:
        return self._lib.tls_first_index(self._h)

    def last_log_index(self) -> int:
        return self._lib.tls_last_index(self._h)

    def get_entry(self, index: int) -> Optional[LogEntry]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.tls_get(self._h, index, ctypes.byref(out))
        if n < 0:
            return None
        try:
            blob = ctypes.string_at(out, n)
        finally:
            self._lib.tls_free(out)
        return LogEntry.decode(blob)

    def append_entries(self, entries: list[LogEntry], sync: bool = True) -> int:
        if not entries:
            return 0
        parts = []
        for e in entries:
            blob = e.encode()
            parts.append(_FRAME.pack(len(blob)))
            parts.append(blob)
        frames = b"".join(parts)
        err = ctypes.create_string_buffer(256)
        n = self._lib.tls_append(self._h, frames, len(frames),
                                 1 if sync else 0, err, 256)
        if n < 0:
            raise ValueError(f"native append failed: {err.value.decode()}")
        return n

    def truncate_prefix(self, first_index_kept: int) -> None:
        if self._lib.tls_truncate_prefix(self._h, first_index_kept) != 0:
            raise IOError("native truncate_prefix failed")

    def truncate_suffix(self, last_index_kept: int) -> None:
        if self._lib.tls_truncate_suffix(self._h, last_index_kept) != 0:
            raise IOError("native truncate_suffix failed")

    def reset(self, next_log_index: int) -> None:
        if self._lib.tls_reset(self._h, next_log_index) != 0:
            raise IOError("native reset failed")

    def configuration_indexes(self) -> list[int]:
        n = self._lib.tls_conf_count(self._h)
        if n == 0:
            return []
        buf = (ctypes.c_int64 * n)()
        got = self._lib.tls_conf_indexes(self._h, buf, n)
        return list(buf[:got])
