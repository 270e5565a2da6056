"""Raft RPC messages + compact binary codec.

Reference parity: protobuf ``RpcRequests.*`` (AppendEntries, RequestVote,
InstallSnapshot, TimeoutNow, ReadIndex, GetFile) — SURVEY.md §3.1 "RPC
layer".  Dataclasses here are the in-proc representation; ``encode``/
``decode`` give a deterministic wire format shared with the native
transport (length-prefixed little-endian fields, LogEntry's own codec for
entries).
"""

from __future__ import annotations

import struct
from dataclasses import MISSING as _MISSING
from dataclasses import dataclass, field
from typing import Optional

from tpuraft_torch.entity import LogEntry

_U16 = struct.Struct("<H")
_I64 = struct.Struct("<q")


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return _U16.pack(len(b)) + b


def _unpack_str(buf: memoryview, off: int) -> tuple[str, int]:
    (n,) = _U16.unpack_from(buf, off)
    off += 2
    return bytes(buf[off : off + n]).decode(), off + n


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _unpack_bytes(buf: memoryview, off: int) -> tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return bytes(buf[off : off + n]), off + n


@dataclass
class SnapshotMeta:
    """Snapshot manifest meta (reference: RaftOutter.SnapshotMeta)."""

    last_included_index: int = 0
    last_included_term: int = 0
    peers: list[str] = field(default_factory=list)
    old_peers: list[str] = field(default_factory=list)
    learners: list[str] = field(default_factory=list)
    old_learners: list[str] = field(default_factory=list)
    # TRAILING extension (witness replicas): omitted when empty, so a
    # witness-free meta encodes bit-identically to the old format and
    # an old decoder ignores the trailing lists of a new one
    witnesses: list[str] = field(default_factory=list)
    old_witnesses: list[str] = field(default_factory=list)

    def encode(self) -> bytes:
        out = bytearray(_I64.pack(self.last_included_index))
        out += _I64.pack(self.last_included_term)
        lists = [self.peers, self.old_peers, self.learners,
                 self.old_learners]
        if self.witnesses or self.old_witnesses:
            lists += [self.witnesses, self.old_witnesses]
        for lst in lists:
            out += _U16.pack(len(lst))
            for s in lst:
                out += _pack_str(s)
        return bytes(out)

    @staticmethod
    def decode(buf: bytes | memoryview) -> "SnapshotMeta":
        buf = memoryview(buf)
        idx, term = _I64.unpack_from(buf, 0)[0], _I64.unpack_from(buf, 8)[0]
        off = 16
        lists = []
        for i in range(6):
            if i >= 4 and off >= len(buf):
                lists.append([])  # pre-witness meta: trailing defaults
                continue
            (n,) = _U16.unpack_from(buf, off)
            off += 2
            cur = []
            for _ in range(n):
                s, off = _unpack_str(buf, off)
                cur.append(s)
            lists.append(cur)
        return SnapshotMeta(idx, term, *lists)


# ---- message dataclasses ---------------------------------------------------
# All carry group_id (multi-raft routing key), server_id (sender), peer_id
# (target) as strings — the reference's protobuf does the same.


@dataclass
class AppendEntriesRequest:
    group_id: str
    server_id: str
    peer_id: str
    term: int
    prev_log_index: int
    prev_log_term: int
    committed_index: int
    entries: list[LogEntry] = field(default_factory=list)
    # heartbeats are empty-entry requests (reference: sendEmptyEntries)
    # TRAILING trace-plane extension (wire-compatible: old decoders
    # stop before it, old encoders leave the default): one packed i64
    # trace context per entry (util/trace.pack_ctx), b"" when no entry
    # of the batch is traced — zero wire cost on the untraced path.
    # Follower-side append/flush spans join the originating trace.
    trace_ctx: bytes = b""


@dataclass
class AppendEntriesResponse:
    term: int
    success: bool
    last_log_index: int  # hint for nextIndex backoff on rejection
    # on a prev-term conflict: the first index of the follower's
    # conflicting term, so the leader can skip the whole term run in one
    # step instead of one-entry-per-RTT linear backoff (classic Raft §5.3
    # fast-backoff optimization; 0 = no hint)
    conflict_index: int = 0
    # capability advertisement: the responder's endpoint runs a
    # NodeManager serving ``multi_heartbeat``, so the leader may
    # auto-coalesce its beats to this endpoint (VERDICT r2 #6)
    multi_hb: bool = False


@dataclass
class RequestVoteRequest:
    group_id: str
    server_id: str
    peer_id: str
    term: int
    last_log_index: int
    last_log_term: int
    pre_vote: bool


@dataclass
class RequestVoteResponse:
    term: int
    granted: bool


@dataclass
class InstallSnapshotRequest:
    group_id: str
    server_id: str
    peer_id: str
    term: int
    meta: SnapshotMeta
    uri: str  # remote://<endpoint>/<reader_id>


@dataclass
class InstallSnapshotResponse:
    term: int
    success: bool


@dataclass
class TimeoutNowRequest:
    group_id: str
    server_id: str
    peer_id: str
    term: int


@dataclass
class TimeoutNowResponse:
    term: int
    success: bool


@dataclass
class ReadIndexRequest:
    group_id: str
    server_id: str
    peer_id: str


@dataclass
class ReadIndexResponse:
    index: int
    success: bool
    # trailing read-plane extensions (wire-compatible: old decoders drop
    # them, old encoders leave the defaults).  On a rejection
    # (success=False) the responder reports its term and its current
    # leader hint so the forwarding follower can re-probe the REAL
    # leader inside the same attempt instead of failing the whole read
    # batch with a terminal error (ReadOnlyService._forward_once).
    term: int = 0
    leader_hint: str = ""


@dataclass
class GetFileRequest:
    reader_id: int
    filename: str
    offset: int
    count: int


@dataclass
class GetFileResponse:
    eof: bool
    data: bytes


@dataclass
class ErrorResponse:
    code: int
    msg: str


# ---- codec -----------------------------------------------------------------
# Extensible registry so other message families (CLI ops, KV ops) claim
# stable type-id ranges: 0-31 raft core, 64-95 CLI, 128-159 KV.

_MSG_TYPES: dict[int, type] = {}
_TYPE_ID: dict[type, int] = {}


def register_message(tid: int, cls: type) -> type:
    if tid in _MSG_TYPES and _MSG_TYPES[tid] is not cls:
        raise ValueError(f"type id {tid} already taken by {_MSG_TYPES[tid]}")
    _MSG_TYPES[tid] = cls
    _TYPE_ID[cls] = tid
    return cls


@dataclass
class MultiHeartbeatRequest:
    """Coalesced heartbeats: one RPC per (src, dst) endpoint pair carries
    the empty-AppendEntries beats of EVERY leader group between them
    (the batched send-matrix plane — SURVEY.md §3.5; no reference
    counterpart, the reference sends per-group heartbeats).  Each beat
    is an encoded AppendEntriesRequest."""

    beats: list[bytes]


@dataclass
class MultiHeartbeatResponse:
    """One frame per beat, in request order: an encoded
    AppendEntriesResponse, or an encoded ErrorResponse for a group that
    was unroutable/unserviceable on the receiver."""

    acks: list[bytes]


@dataclass
class CompactBeat:
    """One steady-state heartbeat as data, not a frame (the beat-plane
    fast path): the receiver validates (term, leader, committed) against
    its row and touches the election deadline INLINE — no node lock, no
    handler task.  Anything unusual (term moved, candidate, committed
    behind, unknown node) answers needs_full and the sender follows up
    with a classic empty-AppendEntries beat carrying full semantics."""

    group_id: str
    server_id: str  # the sending leader
    peer_id: str    # the target node
    term: int
    committed_index: int
    # quiesce handshake: the leader saw N consecutive fully-acked idle
    # rounds and proposes hibernation.  A follower that matches the
    # beat's (term, leader, committed) row AND is at the leader's tail
    # suppresses its election timeout, registers on the sender store's
    # liveness lease (lease_ms horizon), and acks ok; the leader only
    # hibernates once EVERY follower acked — a single refusal keeps the
    # group active (a follower with a live election timer must keep
    # receiving beats).
    quiesce: bool = False
    lease_ms: int = 0


@dataclass
class BeatAck:
    ok: bool            # False => send a full beat (slow path)
    term: int           # receiver's current term (observability only)
    # responder's store clock (monotonic ms) at ack time: piggybacked
    # sample for the sender's peer-skew estimator (ISSUE 18).  Trailing
    # + defaulted: old peers decode as 0 ("no reading").
    clock_ms: int = 0


@dataclass
class StoreLeaseBeat:
    """Store-level liveness lease (ONE per endpoint pair per interval):
    while groups between two stores are quiescent, this tiny beat is the
    only thing proving the sender store alive.  The receiver re-arms the
    sender's lease for ``lease_ms``; on expiry it wakes every quiescent
    group that depends on that store with a randomized election timeout
    (no thundering herd).  The ack, back on the sender, refreshes the
    last_ack rows of the sender's quiescent leader groups toward this
    endpoint — dead-quorum step-down and leader-lease reads for
    hibernating groups consult exactly this lease."""

    endpoint: str   # the sending store's endpoint
    lease_ms: int   # horizon the receiver should hold the lease for


@dataclass
class StoreLeaseAck:
    ok: bool
    # how many quiescent groups on the receiver currently depend on the
    # sender's lease (observability: hub counters / describe)
    dependents: int = 0
    # responder's store clock (monotonic ms) at ack time — same skew
    # probe as BeatAck.clock_ms; 0 = old peer / no reading
    clock_ms: int = 0


@dataclass
class BatchRequest:
    """Generic batched RPC envelope (the send-plane wire unit —
    SURVEY.md §3.5 "batched per-tick (group, peer) send matrices",
    §8.2 "send-plans"): one RPC per (src, dst) endpoint pair carries
    MANY groups' protocol messages.  ``items`` are full request
    messages (AppendEntriesRequest / RequestVoteRequest); the method
    name ("multi_append" / "multi_vote") selects the receiver's
    dispatch.  In-proc transports pass the objects through untouched;
    framed transports nest-encode them at the wire (``list[msg]``)."""

    items: list[msg]  # noqa: F821 — codec annotation, not a type


@dataclass
class BatchResponse:
    """One response message per request item, in order; an
    ErrorResponse marks an item whose group was unroutable or
    unserviceable on the receiver."""

    items: list[msg]  # noqa: F821


@dataclass
class StoreAppendRequest:
    """Store-wide append round (the WRITE-plane mirror of the read
    plane's ``multi_beat_fast`` fence round): one RPC per destination
    endpoint carries the pending entry windows of EVERY led group on
    the sending store whose follower lives there.  Each row is a full
    ``AppendEntriesRequest`` — per-group prev-log/term semantics are
    unchanged, so safety is exactly per-group AppendEntries; only the
    RPC round trip is shared.  Dispatched by ``AppendBatcher``
    (tpuraft/core/append_batcher.py); a receiver that predates it
    answers ENOMETHOD and the sender downgrades PERMANENTLY to
    per-group ``append_entries`` for that endpoint (the PD delta-batch
    / kv_batch mixed-fleet pattern)."""

    rows: list[msg]  # noqa: F821 — AppendEntriesRequest rows


@dataclass
class StoreAppendResponse:
    """One ack per request row, in order: an ``AppendEntriesResponse``,
    or an ``ErrorResponse`` for a row whose node was unroutable or busy
    on the receiver."""

    acks: list[msg]  # noqa: F821


for _i, _t in enumerate([
    AppendEntriesRequest,
    AppendEntriesResponse,
    RequestVoteRequest,
    RequestVoteResponse,
    InstallSnapshotRequest,
    InstallSnapshotResponse,
    TimeoutNowRequest,
    TimeoutNowResponse,
    ReadIndexRequest,
    ReadIndexResponse,
    GetFileRequest,
    GetFileResponse,
    ErrorResponse,
    MultiHeartbeatRequest,
    MultiHeartbeatResponse,
    BatchRequest,
    BatchResponse,
    CompactBeat,
    BeatAck,
    StoreLeaseBeat,
    StoreLeaseAck,
    StoreAppendRequest,
    StoreAppendResponse,
]):
    register_message(_i, _t)




def _ann(f) -> str:
    """Field annotation as a string, whether or not the defining module
    uses ``from __future__ import annotations``."""
    t = f.type
    if isinstance(t, str):
        return t
    if isinstance(t, type):
        return t.__name__
    return str(t)  # e.g. types.GenericAlias: list[str] -> "list[str]"


def encode_message(msg) -> bytes:
    """Wire-encode any message: u8 type id + field stream."""
    tid = _TYPE_ID[type(msg)]
    out = bytearray(struct.pack("<B", tid))
    for name, f in type(msg).__dataclass_fields__.items():
        v = getattr(msg, name)
        ann = _ann(f)
        if ann == "bool":
            out += struct.pack("<B", v)
        elif ann == "int":
            out += _I64.pack(v)
        elif ann == "str":
            out += _pack_str(v)
        elif ann == "bytes":
            out += _pack_bytes(v)
        elif ann == "SnapshotMeta":
            out += _pack_bytes(v.encode())
        elif ann.startswith("list[str]"):
            out += struct.pack("<I", len(v))
            for s in v:
                out += _pack_str(s)
        elif ann.startswith("list[bytes]"):
            out += struct.pack("<I", len(v))
            for b in v:
                out += _pack_bytes(b)
        elif ann.startswith("list[LogEntry]"):
            out += struct.pack("<I", len(v))
            for e in v:
                out += _pack_bytes(e.encode())
        elif ann.startswith("list[msg]"):
            out += struct.pack("<I", len(v))
            for m in v:
                out += _pack_bytes(encode_message(m))
        else:
            raise TypeError(f"cannot encode field {name}={v!r} ({ann})")
    return bytes(out)


def decode_message(buf: bytes | memoryview):
    buf = memoryview(buf)
    (tid,) = struct.unpack_from("<B", buf, 0)
    cls = _MSG_TYPES[tid]
    off = 1
    kwargs = {}
    for name, f in cls.__dataclass_fields__.items():
        if off >= len(buf) and (f.default is not _MISSING
                                or f.default_factory is not _MISSING):
            # a shorter buffer from an old-format sender: trailing
            # fields added since (always declared with defaults) take
            # those defaults — mixed-version fleets keep decoding.
            # Required fields still raise on a genuinely short frame.
            break
        ann = _ann(f)
        if ann == "bool":
            (v,) = struct.unpack_from("<B", buf, off)
            kwargs[name] = bool(v)
            off += 1
        elif ann == "int":
            (kwargs[name],) = _I64.unpack_from(buf, off)
            off += 8
        elif ann == "str":
            kwargs[name], off = _unpack_str(buf, off)
        elif ann == "bytes":
            kwargs[name], off = _unpack_bytes(buf, off)
        elif ann == "SnapshotMeta":
            blob, off = _unpack_bytes(buf, off)
            kwargs[name] = SnapshotMeta.decode(blob)
        elif ann.startswith("list[str]"):
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            items = []
            for _ in range(n):
                s, off = _unpack_str(buf, off)
                items.append(s)
            kwargs[name] = items
        elif ann.startswith("list[bytes]"):
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            blobs = []
            for _ in range(n):
                b, off = _unpack_bytes(buf, off)
                blobs.append(b)
            kwargs[name] = blobs
        elif ann.startswith("list[LogEntry]"):
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            entries = []
            for _ in range(n):
                blob, off = _unpack_bytes(buf, off)
                # wire path: TCP is already checksummed and the journal
                # CRCs records at write time — skip the per-entry CRC
                # (storage reads keep verify=True)
                entries.append(LogEntry.decode(blob, verify=False))
            kwargs[name] = entries
        elif ann.startswith("list[msg]"):
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            msgs = []
            for _ in range(n):
                blob, off = _unpack_bytes(buf, off)
                msgs.append(decode_message(blob))
            kwargs[name] = msgs
        else:
            raise TypeError(f"cannot decode field {name}: {ann}")
    return cls(**kwargs)
