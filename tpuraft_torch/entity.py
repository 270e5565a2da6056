"""Core entities: PeerId, LogId, LogEntry, Task.

Reference parity (SURVEY.md §3.1 "Entities & conf"):
``core:entity/PeerId`` (``ip:port[:idx[:priority]]`` parsing),
``core:entity/LogId{index,term}``, ``core:entity/LogEntry`` with CRC
checksum, ``core:entity/Task{data,done,expectedTerm}``.

Design difference from the reference: entries carry an explicit binary
codec (``encode``/``decode``) used by both the Python file log storage and
the C++ storage engine — one on-disk/wire format, no protobuf dependency in
the hot path.  Indexes/terms are unbounded Python ints on the host; the
device plane (tpuraft.ops) works in *base-relative* int32 space.
"""

from __future__ import annotations

import enum
import functools
import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional


class ElectionPriority:
    """Priority election values (reference: ``core:entity/ElectionPriority``)."""

    DISABLED = -1   # priority election disabled for this node
    NOT_ELECTED = 0 # node never takes part in election
    MIN_VALUE = 1


@dataclass(frozen=True, order=True)
class PeerId:
    """A participant endpoint: ``ip:port[:idx[:priority]]``.

    Reference: ``core:entity/PeerId#parse``.  ``idx`` distinguishes
    multiple nodes of one process sharing an endpoint; ``priority`` feeds
    priority-based election (``[1.3+]``).
    """

    ip: str = "0.0.0.0"
    port: int = 0
    idx: int = 0
    priority: int = ElectionPriority.DISABLED

    @staticmethod
    def parse(s: str) -> "PeerId":
        parts = s.strip().split(":")
        if len(parts) < 2 or len(parts) > 4:
            raise ValueError(f"invalid peer id: {s!r}")
        ip = parts[0]
        port = int(parts[1])
        idx = int(parts[2]) if len(parts) >= 3 else 0
        priority = int(parts[3]) if len(parts) == 4 else ElectionPriority.DISABLED
        return PeerId(ip, port, idx, priority)

    def is_empty(self) -> bool:
        return self.ip == "0.0.0.0" and self.port == 0 and self.idx == 0

    # endpoint and str() are on the per-beat/per-request hot paths
    # (every heartbeat builds both); cache the formatted strings on the
    # frozen instance (cached_property writes __dict__ directly, which
    # bypasses the frozen __setattr__) — eq/hash/order use declared
    # fields only, so the memo never affects identity
    @functools.cached_property
    def endpoint(self) -> str:
        return f"{self.ip}:{self.port}"

    @functools.cached_property
    def _str(self) -> str:
        s = f"{self.ip}:{self.port}"
        if self.priority != ElectionPriority.DISABLED:
            return f"{s}:{self.idx}:{self.priority}"
        if self.idx != 0:
            return f"{s}:{self.idx}"
        return s

    def __str__(self) -> str:
        return self._str


EMPTY_PEER = PeerId()


@dataclass(frozen=True, order=True)
class LogId:
    """(index, term) pair; ordering is by index then term.

    Reference: ``core:entity/LogId``. Raft log comparison for elections
    compares term first, index second — use :meth:`newer_than` for that.
    """

    index: int = 0
    term: int = 0

    def newer_than(self, other: "LogId") -> bool:
        """Election log-up-to-date comparison (term first, then index)."""
        return (self.term, self.index) > (other.term, other.index)

    def __str__(self) -> str:
        return f"LogId[index={self.index}, term={self.term}]"


class EntryType(enum.IntEnum):
    """Reference: ``EnumOutter.EntryType``."""

    NO_OP = 0
    DATA = 1
    CONFIGURATION = 2


# On-disk / wire header for a log entry:
#   magic(1) type(1) reserved(2) term(8) index(8) npeers(2) nold(2)
#   data_len(4) crc32(4)  => 32 bytes, then peers blob, then data.
_HDR = struct.Struct("<BBHqqHHII")
_MAGIC = 0xB8
# decode-path enum lookup (EntryType(x) costs an enum __call__ — ~10%
# of per-entry decode on the replication hot path)
_ETYPES = {m.value: m for m in EntryType}


@dataclass
class LogEntry:
    """A replicated log entry.

    Reference: ``core:entity/LogEntry`` (+ v2 codec ``core:entity/codec/*``).
    CONFIGURATION entries carry ``peers``/``old_peers`` (joint consensus)
    and ``learners``/``old_learners``.
    """

    type: EntryType = EntryType.NO_OP
    id: LogId = field(default_factory=LogId)
    data: bytes = b""
    peers: Optional[list[PeerId]] = None
    old_peers: Optional[list[PeerId]] = None
    learners: Optional[list[PeerId]] = None
    old_learners: Optional[list[PeerId]] = None
    # witness voters (subset of peers/old_peers) — TRAILING extension of
    # the peers blob: entries without witnesses encode bit-identically
    # to the pre-witness format, and an old decoder reading a
    # witness-bearing entry ignores the trailing lists (the witness
    # degrades to a plain voter on old replicas — safe: quorum math is
    # identical, only the payload-stripping optimization is lost)
    witnesses: Optional[list[PeerId]] = None
    old_witnesses: Optional[list[PeerId]] = None
    # trace plane: the originating op's trace context (util/trace).
    # TRANSIENT — never encoded into the journal or the entry codec;
    # the wire carries it as an AppendEntriesRequest TRAILING field so
    # follower append/flush spans join the leader-side trace.  Excluded
    # from equality: a wire-decoded entry must still compare equal to
    # its storage-decoded twin.
    trace_id: int = field(default=0, compare=False, repr=False)

    # -- codec ---------------------------------------------------------------

    def encode(self) -> bytes:
        # Entries are encoded several times on the hot path (log flush +
        # once per follower); the blob is cached per LogId — staging
        # assigns the id once, after which the entry is logically
        # immutable (mirrors the reference encoding entries once into
        # pooled buffers via ByteBufferCollector).
        cached = self.__dict__.get("_enc")
        if cached is not None and cached[0] == self.id:
            return cached[1]
        if (self.peers is None and self.old_peers is None
                and self.learners is None and self.old_learners is None
                and self.witnesses is None and self.old_witnesses is None):
            peers_blob = b""  # DATA/NO_OP fast path (the hot case)
        else:
            peers_blob = _encode_peer_lists(
                self.peers, self.old_peers, self.learners,
                self.old_learners, self.witnesses, self.old_witnesses
            )
        crc = zlib.crc32(self.data)
        crc = zlib.crc32(peers_blob, crc)
        hdr = _HDR.pack(
            _MAGIC,
            self.type.value,
            0,
            self.id.term,
            self.id.index,
            len(peers_blob),
            0,
            len(self.data),
            crc,
        )
        blob = hdr + peers_blob + self.data
        self._enc = (self.id, blob)
        return blob

    @staticmethod
    def decode(buf: bytes | memoryview, verify: bool = True) -> "LogEntry":
        """Decode one entry blob.

        verify=False skips the CRC check — for the RPC WIRE path only
        (TCP is checksummed end-to-end, and the receiver's journal
        computes its own record CRC at write time), where per-entry CRC
        was ~10% of a follower's CPU.  Storage reads always verify:
        disk corruption is the threat this CRC exists for.
        """
        raw = buf if isinstance(buf, bytes) else bytes(buf)
        if len(raw) < _HDR.size:
            raise ValueError(f"log entry truncated: {len(raw)} < {_HDR.size} bytes")
        (magic, etype, _rsv, term, index, peers_len, _n2, data_len, crc) = \
            _HDR.unpack_from(raw)
        if _HDR.size + peers_len + data_len != len(raw):
            raise ValueError(
                f"log entry size mismatch: header says "
                f"{_HDR.size + peers_len + data_len}, have {len(raw)}"
            )
        if magic != _MAGIC:
            raise ValueError(f"bad log entry magic: {magic:#x}")
        off = _HDR.size
        data = raw[off + peers_len:]
        if peers_len:
            peers_blob = raw[off: off + peers_len]
            if verify and zlib.crc32(peers_blob, zlib.crc32(data)) != crc:
                raise ValueError(f"log entry crc mismatch at index {index}")
            (peers, old_peers, learners, old_learners,
             witnesses, old_witnesses) = _decode_peer_lists(peers_blob)
        else:
            if verify and zlib.crc32(data) != crc:
                raise ValueError(f"log entry crc mismatch at index {index}")
            peers = old_peers = learners = old_learners = None
            witnesses = old_witnesses = None
        # direct construction (object.__new__): the dataclass __init__'s
        # 7-kwarg dispatch was measurable at replication rates
        etype_m = _ETYPES.get(etype)
        if etype_m is None:
            # ValueError, like EntryType(etype) raised: the storage
            # recovery scan truncates torn tails on (ValueError,
            # struct.error) — a KeyError would crash startup instead
            raise ValueError(f"bad log entry type: {etype}")
        e = object.__new__(LogEntry)
        e.type = etype_m
        eid = LogId(index, term)
        e.id = eid
        e.data = data
        e.peers = peers
        e.old_peers = old_peers
        e.learners = learners
        e.old_learners = old_learners
        e.witnesses = witnesses
        e.old_witnesses = old_witnesses
        # pre-seed the encode cache with the exact source blob: the
        # entry re-encodes bit-identically (follower staging to the
        # journal, leader fan-out) without paying the codec again
        e._enc = (eid, raw)
        if not verify:
            # mark for the one deferred check at storage-staging time:
            # TCP's 16-bit checksum is weak, and a corrupt blob staged
            # bit-identically would only surface at the NEXT recovery
            # scan — as a spurious "torn tail" truncating acked entries
            e._crc_unverified = True
        return e

    def verify_crc(self) -> None:
        """One deferred CRC check against the cached wire blob.

        Raises ValueError on mismatch.  No-op for locally-built entries
        (``encode`` computes a fresh CRC) and for already-verified ones.
        """
        if not self.__dict__.get("_crc_unverified"):
            return
        cached = self.__dict__.get("_enc")
        if cached is None or cached[0] != self.id:
            self._crc_unverified = False
            return  # will re-encode with a fresh CRC anyway
        raw = cached[1]
        (_m, _t, _r, _term, _idx, peers_len, _n2, _dlen, crc) = \
            _HDR.unpack_from(raw)
        computed = zlib.crc32(raw[_HDR.size + peers_len:])
        if peers_len:
            computed = zlib.crc32(raw[_HDR.size:_HDR.size + peers_len], computed)
        if computed != crc:
            raise ValueError(
                f"log entry crc mismatch at index {self.id.index} (wire)")
        self._crc_unverified = False

    def encoded_size(self) -> int:
        return _HDR.size + len(
            _encode_peer_lists(self.peers, self.old_peers, self.learners,
                               self.old_learners, self.witnesses,
                               self.old_witnesses)
        ) + len(self.data)

    def is_configuration(self) -> bool:
        return self.type == EntryType.CONFIGURATION


def _encode_peer_lists(*lists: Optional[list[PeerId]]) -> bytes:
    """Encode up to 6 peer lists (peers, old_peers, learners,
    old_learners[, witnesses, old_witnesses]).  The witness pair is a
    TRAILING extension: omitted entirely when both are None, so
    witness-free entries keep the exact pre-witness byte format (old
    decoders read 4 lists and ignore any trailing bytes)."""
    if all(l is None for l in lists):
        return b""
    base, tail = lists[:4], lists[4:]
    if all(l is None for l in tail):
        lists = base
    out = bytearray()
    for l in lists:
        if l is None:
            out += struct.pack("<h", -1)
        else:
            out += struct.pack("<h", len(l))
            for p in l:
                s = str(p).encode()
                out += struct.pack("<H", len(s)) + s
    return bytes(out)


def _decode_peer_lists(blob: bytes):
    if not blob:
        return None, None, None, None, None, None
    lists: list[Optional[list[PeerId]]] = []
    off = 0
    for _ in range(6):
        if len(lists) >= 4 and off >= len(blob):
            # pre-witness entry: trailing lists default to None
            lists.append(None)
            continue
        (n,) = struct.unpack_from("<h", blob, off)
        off += 2
        if n < 0:
            lists.append(None)
            continue
        cur = []
        for _ in range(n):
            (slen,) = struct.unpack_from("<H", blob, off)
            off += 2
            cur.append(PeerId.parse(blob[off : off + slen].decode()))
            off += slen
        lists.append(cur)
    return tuple(lists)  # type: ignore[return-value]


def strip_entry_payload(e: LogEntry) -> LogEntry:
    """Witness replication: a DATA entry's payload is replaced by an
    empty body, keeping (index, term) — the witness's metadata-only
    journal stores exactly what elections and quorum intersection need.
    CONFIGURATION entries (and their peer lists) pass through whole:
    membership IS metadata.  The wire blob's deferred CRC is verified
    first, so a corrupt frame cannot launder bad metadata into the
    journal via the strip."""
    if e.type != EntryType.DATA or not e.data:
        return e
    e.verify_crc()
    return LogEntry(type=e.type, id=e.id, data=b"")


@dataclass
class Task:
    """A user task to replicate: opaque ``data`` + completion callback.

    Reference: ``core:entity/Task``.  ``done`` is called with a Status when
    the entry commits (or fails); ``expected_term`` guards against applying
    under a different leadership than intended.
    """

    data: bytes = b""
    done: Optional[Callable[["Any"], None]] = None  # called with Status
    expected_term: int = -1
    # trace plane: carried onto the staged LogEntry (util/trace); 0 =
    # untraced (the steady state)
    trace_id: int = field(default=0, compare=False, repr=False)
    # pipelined apply (write plane): ``done`` fires the moment the entry
    # COMMITS instead of after the FSM applies it — only valid for ops
    # whose result is known a priori (blind writes); the read-fence
    # machinery (read_index + wait_applied) keeps reads observing
    # applied state.  See FSMCaller's eager-ack path.
    ack_at_commit: bool = field(default=False, compare=False, repr=False)
