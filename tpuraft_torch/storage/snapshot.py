"""Local snapshot storage: writers, readers, atomic commit, remote serving.

Reference parity (SURVEY.md §3.1 "Snapshot subsystem"):
``LocalSnapshotStorage`` (temp dir -> atomic rename ``snapshot_<index>``),
``LocalSnapshotWriter``/``Reader``, ``LocalSnapshotMetaTable`` (manifest
with per-file checksums), ``SnapshotFileReader`` (chunked remote serving
for ``GetFileRequest``).

Layout::

    <root>/temp/                  in-progress writer dir
    <root>/snapshot_<index>/      committed snapshots
        __snapshot_meta           manifest: SnapshotMeta + file table
        <user files...>
"""

from __future__ import annotations

import asyncio
import os
import shutil
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional

from tpuraft_torch.rpc.messages import SnapshotMeta

_MANIFEST = "__snapshot_meta"


class ThroughputSnapshotThrottle:
    """Byte-rate throttle for snapshot file copy.

    Reference parity: ``core:storage/ThroughputSnapshotThrottle`` —
    caps install-snapshot bandwidth so a bulk file copy can't starve
    the log-replication traffic sharing the transport.  Token bucket
    with a one-second burst capacity; the file service asks it how many
    of the requested bytes may be served *now* and awaits the rest.
    """

    def __init__(self, bytes_per_sec: int, clock=time.monotonic):
        assert bytes_per_sec > 0
        self._rate = float(bytes_per_sec)
        self._avail = float(bytes_per_sec)
        self._clock = clock
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._avail = min(self._rate, self._avail + (now - self._last) * self._rate)
        self._last = now

    def throttled_by_throughput(self, n: int) -> int:
        """Take up to ``n`` bytes from the bucket; returns the granted count."""
        self._refill()
        take = min(n, int(self._avail))
        self._avail -= take
        return take

    async def acquire_upto(self, n: int) -> int:
        """Await until at least one byte is available, then grant <= n."""
        if n <= 0:
            return 0
        while True:
            take = self.throttled_by_throughput(n)
            if take > 0:
                return take
            # time until one byte refills (bounded for clock hiccups)
            await asyncio.sleep(min(0.1, max(1.0 / self._rate, 1e-4)))


@dataclass
class _FileRecord:
    name: str
    size: int
    crc: int


def _encode_manifest(meta: SnapshotMeta, files: list[_FileRecord]) -> bytes:
    mb = meta.encode()
    out = bytearray(struct.pack("<I", len(mb)) + mb)
    out += struct.pack("<H", len(files))
    for f in files:
        nb = f.name.encode()
        out += struct.pack("<H", len(nb)) + nb + struct.pack("<qI", f.size, f.crc)
    body = bytes(out)
    return struct.pack("<I", zlib.crc32(body)) + body


def _decode_manifest(blob: bytes) -> tuple[SnapshotMeta, list[_FileRecord]]:
    (crc,) = struct.unpack_from("<I", blob, 0)
    body = blob[4:]
    if zlib.crc32(body) != crc:
        raise ValueError("snapshot manifest crc mismatch")
    (mlen,) = struct.unpack_from("<I", body, 0)
    meta = SnapshotMeta.decode(body[4 : 4 + mlen])
    off = 4 + mlen
    (nfiles,) = struct.unpack_from("<H", body, off)
    off += 2
    files = []
    for _ in range(nfiles):
        (nlen,) = struct.unpack_from("<H", body, off)
        off += 2
        name = body[off : off + nlen].decode()
        off += nlen
        size, fcrc = struct.unpack_from("<qI", body, off)
        off += 12
        files.append(_FileRecord(name, size, fcrc))
    return meta, files


class SnapshotWriter:
    def __init__(self, temp_dir: str):
        self._dir = temp_dir
        self._files: list[_FileRecord] = []
        os.makedirs(temp_dir, exist_ok=True)

    @property
    def path(self) -> str:
        return self._dir

    def write_file(self, name: str, data: bytes) -> None:
        """Write one snapshot file (FSM-facing API)."""
        assert "/" not in name and name != _MANIFEST
        p = os.path.join(self._dir, name)
        with open(p, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        self._files.append(_FileRecord(name, len(data), zlib.crc32(data)))

    def add_file(self, name: str) -> None:
        """Register a file the FSM wrote directly into writer.path."""
        p = os.path.join(self._dir, name)
        with open(p, "rb") as f:
            data = f.read()
        self._files.append(_FileRecord(name, len(data), zlib.crc32(data)))

    def list_files(self) -> list[str]:
        return [f.name for f in self._files]

    def save_meta(self, meta: SnapshotMeta) -> None:
        blob = _encode_manifest(meta, self._files)
        p = os.path.join(self._dir, _MANIFEST)
        with open(p, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())


class SnapshotReader:
    def __init__(self, snapshot_dir: str):
        self._dir = snapshot_dir
        with open(os.path.join(snapshot_dir, _MANIFEST), "rb") as f:
            self.meta, self._files = _decode_manifest(f.read())

    @property
    def path(self) -> str:
        return self._dir

    def load_meta(self) -> SnapshotMeta:
        return self.meta

    def list_files(self) -> list[str]:
        return [f.name for f in self._files]

    def files(self) -> list[_FileRecord]:
        """Manifest records (name/size/crc) — the filter-before-copy key."""
        return list(self._files)

    def total_size(self) -> int:
        return sum(f.size for f in self._files)

    def read_file(self, name: str) -> Optional[bytes]:
        rec = next((f for f in self._files if f.name == name), None)
        if rec is None:
            return None
        with open(os.path.join(self._dir, name), "rb") as f:
            data = f.read()
        if zlib.crc32(data) != rec.crc:
            raise IOError(f"snapshot file {name} crc mismatch")
        return data

    # chunked access for remote copy (reference: SnapshotFileReader)
    def read_chunk(self, name: str, offset: int, count: int
                   ) -> tuple[bytes, bool]:
        if name == _MANIFEST:
            p = os.path.join(self._dir, _MANIFEST)
        else:
            rec = next((f for f in self._files if f.name == name), None)
            if rec is None:
                raise FileNotFoundError(name)
            p = os.path.join(self._dir, name)
        with open(p, "rb") as f:
            f.seek(offset)
            data = f.read(count)
            eof = f.tell() >= os.path.getsize(p)
        return data, eof


class LocalSnapshotStorage:
    """Reference: LocalSnapshotStorage — atomic temp->snapshot_<index>."""

    def __init__(self, root: str):
        self._root = root
        # byte deltas of the most recent commit (committed dir size,
        # bytes reclaimed by the prune) — the SnapshotExecutor reads
        # these into the store's DiskBudget; plain attrs, single commit
        # in flight per storage (the executor serializes saves)
        self.last_commit_bytes = 0
        self.last_reclaimed_bytes = 0

    def init(self) -> None:
        os.makedirs(self._root, exist_ok=True)
        # a leftover temp dir is an aborted snapshot: discard
        tmp = os.path.join(self._root, "temp")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        # sweep orphans a crash mid-commit leaves behind: stale
        # snapshot_<N> dirs older than the newest LOADABLE one (the
        # prune after os.replace never ran), and unreadable newer dirs
        # (replace landed but the manifest never got durable).  Without
        # this they leak until the disk fills — the disk-pressure soak
        # finds the leak first.
        dirs = self._snapshot_dirs()
        newest_valid = None
        for idx, path in reversed(dirs):
            try:
                SnapshotReader(path)
                newest_valid = idx
                break
            except (IOError, ValueError):
                continue
        if newest_valid is None:
            return  # nothing loadable: keep everything for forensics
        for idx, path in dirs:
            if idx != newest_valid:
                shutil.rmtree(path, ignore_errors=True)

    def _snapshot_dirs(self) -> list[tuple[int, str]]:
        out = []
        for n in os.listdir(self._root):
            if n.startswith("snapshot_"):
                try:
                    out.append((int(n[len("snapshot_"):]),
                                os.path.join(self._root, n)))
                except ValueError:
                    continue
        return sorted(out)

    def create(self) -> SnapshotWriter:
        tmp = os.path.join(self._root, "temp")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        return SnapshotWriter(tmp)

    @staticmethod
    def _dir_bytes(path: str) -> int:
        total = 0
        try:
            for n in os.listdir(path):
                try:
                    total += os.path.getsize(os.path.join(path, n))
                except OSError:
                    pass
        except OSError:
            pass
        return total

    def commit(self, writer: SnapshotWriter, meta: SnapshotMeta) -> str:
        writer.save_meta(meta)
        dst = os.path.join(self._root, f"snapshot_{meta.last_included_index}")
        if os.path.exists(dst):
            shutil.rmtree(dst)
        os.replace(writer.path, dst)
        fd = os.open(self._root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        self.last_commit_bytes = self._dir_bytes(dst)
        # keep only the newest snapshot (reference keeps last 1 by default)
        reclaimed = 0
        for idx, path in self._snapshot_dirs()[:-1]:
            reclaimed += self._dir_bytes(path)
            shutil.rmtree(path, ignore_errors=True)
        self.last_reclaimed_bytes = reclaimed
        return dst

    def open(self) -> Optional[SnapshotReader]:
        dirs = self._snapshot_dirs()
        if not dirs:
            return None
        # newest first; skip corrupt ones
        for idx, path in reversed(dirs):
            try:
                return SnapshotReader(path)
            except (IOError, ValueError):
                import logging

                logging.getLogger(__name__).exception(
                    "corrupt snapshot at %s; trying older", path)
                continue
        return None


class RemoteFileCopier:
    """Follower-side chunked download of a remote snapshot
    (reference: remote/RemoteFileCopier over GetFileRequest)."""

    def __init__(self, transport, endpoint: str, reader_id: int,
                 chunk_size: int = 1 << 20):
        self._transport = transport
        self._endpoint = endpoint
        self._reader_id = reader_id
        self._chunk = chunk_size

    async def copy_to(self, filename: str, dst_path: str) -> int:
        from tpuraft_torch.rpc.messages import GetFileRequest

        offset = 0
        with open(dst_path, "wb") as f:
            while True:
                resp = await self._transport.get_file(
                    self._endpoint,
                    GetFileRequest(reader_id=self._reader_id,
                                   filename=filename, offset=offset,
                                   count=self._chunk))
                f.write(resp.data)
                offset += len(resp.data)
                if resp.eof:
                    break
            f.flush()
            os.fsync(f.fileno())
        return offset

    async def read_bytes(self, filename: str) -> bytes:
        from tpuraft_torch.rpc.messages import GetFileRequest

        out = bytearray()
        while True:
            resp = await self._transport.get_file(
                self._endpoint,
                GetFileRequest(reader_id=self._reader_id, filename=filename,
                               offset=len(out), count=self._chunk))
            out += resp.data
            if resp.eof:
                return bytes(out)
