"""KVOperation: the serialized command replicated through raft.

Reference parity: ``rhea:storage/KVOperation`` — an op-code plus
key/value/extras, created by ``RaftRawKVStore`` and consumed by
``KVStoreStateMachine#onApply`` (SURVEY.md §3.2 "RawKVStore stack").

Wire layout: ``u8 op | u32 klen | key | u32 vlen | value | u32 alen |
aux`` — ``aux`` packs op-specific extras (CAS expect value, scan bounds,
sequence step, lock lease...).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field


class KVOp(enum.IntEnum):
    PUT = 1
    PUT_IF_ABSENT = 2
    DELETE = 3
    COMPARE_PUT = 4            # CAS
    DELETE_RANGE = 5
    GET_SEQUENCE = 6
    MERGE = 7
    PUT_LIST = 8
    DELETE_LIST = 9
    GET_AND_PUT = 10
    RESET_SEQUENCE = 11
    KEY_LOCK = 12
    KEY_LOCK_RELEASE = 13
    RANGE_SPLIT = 14
    # composite: many sub-ops in ONE log entry (the server-side batch
    # plane — kv_command_batch items for one region ride a single
    # quorum round; the FSM applies sub-ops in order with per-op
    # results).  Never sent by clients directly.
    MULTI = 15
    # region-merge choreography (the lifecycle plane): SEAL is the
    # merge barrier replicated through the SOURCE group (writes behind
    # it in the log still apply; writes after it are deterministically
    # rejected on every replica), ABSORB carries the sealed keyspace
    # into the TARGET group's log (range extension + epoch bump apply
    # deterministically on every target replica), COMMIT retires the
    # source group after the target acked the absorb.  Never sent by
    # clients — proposed leader-side by the store engine.
    MERGE_SEAL = 16
    MERGE_ABSORB = 17
    MERGE_COMMIT = 18
    # read ops (only replicated when linearizable-via-log is requested;
    # normally served via readIndex + local read)
    GET = 20
    MULTI_GET = 21
    SCAN = 22
    CONTAINS_KEY = 23


@dataclass
class KVOperation:
    op: int
    key: bytes = b""
    value: bytes = b""
    aux: bytes = b""
    # trace plane: the originating client op's context (util/trace),
    # TRANSIENT — not part of the wire layout above (the batch request
    # carries contexts in its own trailing field); excluded from
    # equality so decoded ops compare equal to their originals
    trace_id: int = field(default=0, compare=False, repr=False)

    def encode(self) -> bytes:
        return (struct.pack("<B", self.op)
                + struct.pack("<I", len(self.key)) + self.key
                + struct.pack("<I", len(self.value)) + self.value
                + struct.pack("<I", len(self.aux)) + self.aux)

    @staticmethod
    def decode(buf: bytes | memoryview) -> "KVOperation":
        buf = memoryview(buf)
        (op,) = struct.unpack_from("<B", buf, 0)
        off = 1
        parts = []
        for _ in range(3):
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            parts.append(bytes(buf[off:off + n]))
            off += n
        return KVOperation(op, *parts)

    # -- aux packers ---------------------------------------------------------

    @staticmethod
    def cas(key: bytes, expect: bytes, update: bytes) -> "KVOperation":
        return KVOperation(KVOp.COMPARE_PUT, key, update, expect)

    @staticmethod
    def delete_range(start: bytes, end: bytes) -> "KVOperation":
        return KVOperation(KVOp.DELETE_RANGE, start, end)

    @staticmethod
    def get_sequence(key: bytes, step: int) -> "KVOperation":
        return KVOperation(KVOp.GET_SEQUENCE, key, aux=struct.pack("<q", step))

    @staticmethod
    def key_lock(key: bytes, locker_id: bytes, lease_ms: int,
                 keep_lease: bool) -> "KVOperation":
        return KVOperation(
            KVOp.KEY_LOCK, key, locker_id,
            struct.pack("<qB", lease_ms, int(keep_lease)))

    @staticmethod
    def key_unlock(key: bytes, locker_id: bytes) -> "KVOperation":
        return KVOperation(KVOp.KEY_LOCK_RELEASE, key, locker_id)

    @staticmethod
    def range_split(new_region_id: int, split_key: bytes) -> "KVOperation":
        return KVOperation(KVOp.RANGE_SPLIT, split_key,
                           aux=struct.pack("<q", new_region_id))

    @staticmethod
    def merge_seal(target_region_id: int) -> "KVOperation":
        """Merge barrier for the SOURCE group: aux names the absorbing
        region so every replica records where its keyspace went."""
        return KVOperation(KVOp.MERGE_SEAL,
                           aux=struct.pack("<q", target_region_id))

    @staticmethod
    def merge_absorb(source_region_id: int, source_start: bytes,
                     source_end: bytes, data_blob: bytes) -> "KVOperation":
        """Keyspace handoff for the TARGET group: value carries the
        source's serialized range, aux its id + boundaries so the range
        extension applies deterministically on every replica."""
        aux = (struct.pack("<q", source_region_id)
               + struct.pack("<I", len(source_start)) + source_start
               + struct.pack("<I", len(source_end)) + source_end)
        return KVOperation(KVOp.MERGE_ABSORB, value=data_blob, aux=aux)

    @staticmethod
    def unpack_merge_absorb(aux: bytes) -> tuple[int, bytes, bytes]:
        (src_id,) = struct.unpack_from("<q", aux, 0)
        off = 8
        (sl,) = struct.unpack_from("<I", aux, off)
        off += 4
        start = aux[off:off + sl]
        off += sl
        (el,) = struct.unpack_from("<I", aux, off)
        off += 4
        return src_id, start, aux[off:off + el]

    @staticmethod
    def merge_commit(target_region_id: int) -> "KVOperation":
        """Retirement entry for the SOURCE group, proposed once the
        target acked the absorb."""
        return KVOperation(KVOp.MERGE_COMMIT,
                           aux=struct.pack("<q", target_region_id))

    @staticmethod
    def put_list(kvs: list[tuple[bytes, bytes]]) -> "KVOperation":
        blob = bytearray(struct.pack("<I", len(kvs)))
        for k, v in kvs:
            blob += struct.pack("<I", len(k)) + k
            blob += struct.pack("<I", len(v)) + v
        return KVOperation(KVOp.PUT_LIST, value=bytes(blob))

    @staticmethod
    def unpack_kv_list(blob: bytes) -> list[tuple[bytes, bytes]]:
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        out = []
        for _ in range(n):
            (kl,) = struct.unpack_from("<I", blob, off)
            off += 4
            k = blob[off:off + kl]
            off += kl
            (vl,) = struct.unpack_from("<I", blob, off)
            off += 4
            out.append((k, blob[off:off + vl]))
            off += vl
        return out

    @staticmethod
    def pack_key_list(keys: list[bytes]) -> bytes:
        blob = bytearray(struct.pack("<I", len(keys)))
        for k in keys:
            blob += struct.pack("<I", len(k)) + k
        return bytes(blob)

    @staticmethod
    def delete_list(keys: list[bytes]) -> "KVOperation":
        return KVOperation(KVOp.DELETE_LIST,
                           value=KVOperation.pack_key_list(keys))

    @staticmethod
    def multi(ops: list["KVOperation"]) -> "KVOperation":
        """One log entry carrying many sub-ops (see KVOp.MULTI)."""
        blob = bytearray(struct.pack("<I", len(ops)))
        for op in ops:
            enc = op.encode()
            blob += struct.pack("<I", len(enc)) + enc
        return KVOperation(KVOp.MULTI, value=bytes(blob))

    @staticmethod
    def unpack_multi(blob: bytes) -> list["KVOperation"]:
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        out = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", blob, off)
            off += 4
            out.append(KVOperation.decode(blob[off:off + ln]))
            off += ln
        return out

    @staticmethod
    def multi_get(keys: list[bytes]) -> "KVOperation":
        return KVOperation(KVOp.MULTI_GET,
                           value=KVOperation.pack_key_list(keys))

    @staticmethod
    def unpack_key_list(blob: bytes) -> list[bytes]:
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        out = []
        for _ in range(n):
            (kl,) = struct.unpack_from("<I", blob, off)
            off += 4
            out.append(blob[off:off + kl])
            off += kl
        return out
