"""RawKVStore: the storage interface under the raft layer + memory impl.

Reference parity: ``rhea:storage/RawKVStore`` /
``rhea:storage/MemoryRawKVStore`` / ``rhea:storage/RocksRawKVStore``
(SURVEY.md §3.2).  One store instance is SHARED by all regions of a
process — regions are key ranges over the same keyspace, exactly as the
reference shares one RocksDB across RegionEngines.  The native C++
engine (tpuraft.storage native seam) can replace MemoryRawKVStore via
the same interface.

Sequences and locks live in separate namespaces (the reference uses
RocksDB column families / separate TreeMaps) so data scans never see
them; region snapshots serialize all three namespaces range-wise.
"""

from __future__ import annotations

import bisect
import struct
import time
from dataclasses import dataclass
from typing import Iterable, Optional


@dataclass
class Sequence:
    start: int
    end: int


@dataclass
class LockOwner:
    locker_id: bytes
    deadline: float        # monotonic seconds
    fencing_token: int
    acquires: int = 1      # reentrant acquisition count

    def expired(self, now: Optional[float] = None) -> bool:
        # graftcheck: allow(raw-clock) — KV lock-lease default deadline: process-local TTL, not consensus timing
        return (now if now is not None else time.monotonic()) >= self.deadline


class RawKVStore:
    """Synchronous KV storage under one region's state machine.

    All ranges are ``[start, end)``; ``b""`` end means +inf.
    """

    # -- reads ---------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def multi_get(self, keys: list[bytes]) -> dict[bytes, Optional[bytes]]:
        return {k: self.get(k) for k in keys}

    def contains_key(self, key: bytes) -> bool:
        return self.get(key) is not None

    def scan(self, start: bytes, end: bytes, limit: int = -1,
             return_value: bool = True) -> list[tuple[bytes, Optional[bytes]]]:
        raise NotImplementedError

    def reverse_scan(self, start: bytes, end: bytes, limit: int = -1,
                     return_value: bool = True
                     ) -> list[tuple[bytes, Optional[bytes]]]:
        out = self.scan(start, end, -1, return_value)
        out.reverse()
        return out[:limit] if limit >= 0 else out

    # -- writes --------------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def put_list(self, kvs: list[tuple[bytes, bytes]]) -> None:
        for k, v in kvs:
            self.put(k, v)

    def put_if_absent(self, key: bytes, value: bytes) -> Optional[bytes]:
        prev = self.get(key)
        if prev is None:
            self.put(key, value)
        return prev

    def get_and_put(self, key: bytes, value: bytes) -> Optional[bytes]:
        prev = self.get(key)
        self.put(key, value)
        return prev

    def compare_and_put(self, key: bytes, expect: bytes, update: bytes) -> bool:
        actual = self.get(key)
        if actual is None or actual != expect:
            return False
        self.put(key, update)
        return True

    def merge(self, key: bytes, value: bytes) -> None:
        """Append-style merge (reference: RocksDB merge operator with
        stringappend separated by a comma)."""
        prev = self.get(key)
        self.put(key, value if prev is None else prev + b"," + value)

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def delete_list(self, keys: list[bytes]) -> None:
        for k in keys:
            self.delete(k)

    def apply_write_batch(self, ops: list[tuple[bytes, Optional[bytes]]]
                          ) -> None:
        """Apply a mixed run of puts (``(key, value)``) and deletes
        (``(key, None)``) in order.  The FSM's apply coalescer flushes
        whole PUT/DELETE runs through this; engines with a batch write
        path (the native store's ``tkv_apply_batch``) override it with
        ONE atomic call instead of one per op."""
        for k, v in ops:
            if v is None:
                self.delete(k)
            else:
                self.put(k, v)

    def delete_range(self, start: bytes, end: bytes) -> None:
        for k, _ in self.scan(start, end, -1, return_value=False):
            self.delete(k)

    def reset_range(self, start: bytes, end: bytes) -> None:
        """Clear EVERY namespace (data, sequences, locks) in [start, end).
        Snapshot load must be an exact state reset — merging would leave
        post-snapshot sequence/lock keys behind and make log replay after
        restart non-deterministic across replicas."""
        raise NotImplementedError

    # -- sequences -----------------------------------------------------------

    def get_sequence(self, key: bytes, step: int) -> Sequence:
        raise NotImplementedError

    def reset_sequence(self, key: bytes) -> None:
        raise NotImplementedError

    # -- distributed lock primitives ----------------------------------------

    def try_lock_with(self, key: bytes, locker_id: bytes, lease_ms: int,
                      keep_lease: bool) -> tuple[bool, int, bytes]:
        """Returns (acquired, fencing_token, current_owner_id)."""
        raise NotImplementedError

    def release_lock(self, key: bytes, locker_id: bytes) -> bool:
        raise NotImplementedError

    # -- admin / split support ----------------------------------------------

    def approximate_keys_in_range(self, start: bytes, end: bytes) -> int:
        return len(self.scan(start, end, -1, return_value=False))

    def jump_over(self, start: bytes, end: bytes, distance: int
                  ) -> Optional[bytes]:
        """The key `distance` entries after start within [start, end) —
        split-point discovery (reference: RocksRawKVStore#jumpOver)."""
        keys = self.scan(start, end, distance + 1, return_value=False)
        if len(keys) <= distance:
            return None
        return keys[distance][0]

    # -- snapshot support ----------------------------------------------------

    def serialize_range(self, start: bytes, end: bytes) -> bytes:
        raise NotImplementedError

    def load_serialized(self, blob: bytes) -> None:
        raise NotImplementedError


def _in_range(key: bytes, start: bytes, end: bytes) -> bool:
    if start and key < start:
        return False
    if end and key >= end:
        return False
    return True


class MemoryRawKVStore(RawKVStore):
    """Dict-backed store with a lazily-rebuilt sorted key index.

    Writes are O(1); the sorted view is rebuilt on the first range read
    after a write burst (reference MemoryRawKVStore uses a skip-list
    TreeMap; the C++ engine provides the production-grade ordered store).
    """

    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}
        self._sorted: list[bytes] = []
        self._dirty = False
        self._sequences: dict[bytes, int] = {}
        self._locks: dict[bytes, LockOwner] = {}
        self._fencing = 0

    # -- reads ---------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def _keys(self) -> list[bytes]:
        if self._dirty:
            self._sorted = sorted(self._data)
            self._dirty = False
        return self._sorted

    def scan(self, start: bytes, end: bytes, limit: int = -1,
             return_value: bool = True) -> list[tuple[bytes, Optional[bytes]]]:
        keys = self._keys()
        lo = bisect.bisect_left(keys, start) if start else 0
        hi = bisect.bisect_left(keys, end) if end else len(keys)
        sel = keys[lo:hi]
        if limit >= 0:
            sel = sel[:limit]
        if return_value:
            return [(k, self._data[k]) for k in sel]
        return [(k, None) for k in sel]

    # -- writes --------------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            self._dirty = True
        self._data[key] = value

    def approximate_keys_in_range(self, start: bytes, end: bytes) -> int:
        # O(log n) against the sorted index — this runs on the store
        # heartbeat hot loop for every leader region, so the base class's
        # materialize-the-whole-range default is not acceptable here
        keys = self._keys()
        lo = bisect.bisect_left(keys, start) if start else 0
        hi = bisect.bisect_left(keys, end) if end else len(keys)
        return hi - lo

    def delete(self, key: bytes) -> None:
        if self._data.pop(key, None) is not None:
            self._dirty = True

    def reset_range(self, start: bytes, end: bytes) -> None:
        self.delete_range(start, end)
        for d in (self._sequences, self._locks):
            for k in [k for k in d if _in_range(k, start, end)]:
                del d[k]

    # -- sequences -----------------------------------------------------------

    def get_sequence(self, key: bytes, step: int) -> Sequence:
        cur = self._sequences.get(key, 0)
        if step <= 0:
            return Sequence(cur, cur)
        self._sequences[key] = cur + step
        return Sequence(cur, cur + step)

    def reset_sequence(self, key: bytes) -> None:
        self._sequences.pop(key, None)

    # -- locks ---------------------------------------------------------------

    def try_lock_with(self, key: bytes, locker_id: bytes, lease_ms: int,
                      keep_lease: bool) -> tuple[bool, int, bytes]:
        # graftcheck: allow(raw-clock) — KV lock-lease deadline: process-local TTL, not consensus timing
        now = time.monotonic()
        owner = self._locks.get(key)
        if owner is not None and not owner.expired(now):
            if owner.locker_id == locker_id:
                if keep_lease:
                    # pure lease renewal (watchdog): no new hold to release
                    owner.deadline = now + lease_ms / 1000.0
                else:
                    owner.acquires += 1  # reentrant acquire
                return True, owner.fencing_token, locker_id
            return False, owner.fencing_token, owner.locker_id
        self._fencing += 1
        self._locks[key] = LockOwner(locker_id, now + lease_ms / 1000.0,
                                     self._fencing)
        return True, self._fencing, locker_id

    def release_lock(self, key: bytes, locker_id: bytes) -> bool:
        owner = self._locks.get(key)
        if owner is None:
            return True
        if owner.locker_id != locker_id and not owner.expired():
            return False
        owner.acquires -= 1
        if owner.acquires <= 0 or owner.locker_id != locker_id:
            del self._locks[key]
        return True

    # -- snapshot ------------------------------------------------------------

    def serialize_range(self, start: bytes, end: bytes) -> bytes:
        kvs = self.scan(start, end)
        seqs = [(k, v) for k, v in self._sequences.items()
                if _in_range(k, start, end)]
        locks = [(k, o) for k, o in self._locks.items()
                 if _in_range(k, start, end)]
        out = bytearray(struct.pack("<III", len(kvs), len(seqs), len(locks)))
        for k, v in kvs:
            out += struct.pack("<I", len(k)) + k
            out += struct.pack("<I", len(v)) + v
        for k, v in seqs:
            out += struct.pack("<I", len(k)) + k + struct.pack("<q", v)
        # graftcheck: allow(raw-clock) — lock-lease persisted as REMAINING duration; stamps never cross stores
        now = time.monotonic()
        for k, o in locks:
            out += struct.pack("<I", len(k)) + k
            out += struct.pack("<I", len(o.locker_id)) + o.locker_id
            # persist remaining lease, not an absolute monotonic stamp
            out += struct.pack("<dqI", max(0.0, o.deadline - now),
                               o.fencing_token, o.acquires)
        out += struct.pack("<q", self._fencing)
        return bytes(out)

    def load_serialized(self, blob: bytes) -> None:
        buf = memoryview(blob)
        nkv, nseq, nlock = struct.unpack_from("<III", buf, 0)
        off = 12
        for _ in range(nkv):
            (kl,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = bytes(buf[off:off + kl])
            off += kl
            (vl,) = struct.unpack_from("<I", buf, off)
            off += 4
            self.put(k, bytes(buf[off:off + vl]))
            off += vl
        for _ in range(nseq):
            (kl,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = bytes(buf[off:off + kl])
            off += kl
            (v,) = struct.unpack_from("<q", buf, off)
            off += 8
            self._sequences[k] = v
        # graftcheck: allow(raw-clock) — lock-lease persisted as REMAINING duration; stamps never cross stores
        now = time.monotonic()
        for _ in range(nlock):
            (kl,) = struct.unpack_from("<I", buf, off)
            off += 4
            k = bytes(buf[off:off + kl])
            off += kl
            (ll,) = struct.unpack_from("<I", buf, off)
            off += 4
            lid = bytes(buf[off:off + ll])
            off += ll
            remain, token, acquires = struct.unpack_from("<dqI", buf, off)
            off += 20
            self._locks[k] = LockOwner(lid, now + remain, token, acquires)
        (fencing,) = struct.unpack_from("<q", buf, off)
        self._fencing = max(self._fencing, fencing)


class MetricsRawKVStore(RawKVStore):
    """Latency/ops decorator (reference: ``rhea:storage/MetricsRawKVStore``).

    Forwarders are generated from the inner store's public callables at
    construction time (instance attributes shadow the abstract base-class
    methods), so new ``RawKVStore`` methods — and any specialized batch
    implementations a concrete store adds — forward automatically and get
    a ``kv_<op>`` timing histogram without hand-written boilerplate.
    """

    def __init__(self, inner: RawKVStore, metrics) -> None:
        self._inner = inner
        self._metrics = metrics
        for name in dir(inner):
            if name.startswith("_"):
                continue
            attr = getattr(inner, name)
            if callable(attr):
                setattr(self, name, self._timed(name, attr))

    def _timed(self, name: str, fn):
        def timed(*a, **kw):
            # graftcheck: allow(raw-clock) — op-latency metric timing, not consensus timing
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                self._metrics.update(
                    # graftcheck: allow(raw-clock) — op-latency metric timing, not consensus timing
                    f"kv_{name}", (time.monotonic() - t0) * 1000.0)

        return timed

    def __getattr__(self, name: str):
        # non-callable attributes and anything set on the inner store
        # after construction
        return getattr(self._inner, name)
