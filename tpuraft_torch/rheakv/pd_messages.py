"""Placement driver RPC messages.

Reference parity: the PD request/response protocol under
``rhea:cmd/pd/*`` (GetClusterInfo, StoreHeartbeat, RegionHeartbeat,
CreateRegionId...) — SURVEY.md §3.2 "PD server".  Type ids 140+.

All PD responses carry ``success`` + optional ``redirect`` (the PD
leader's endpoint) because the PD metadata store is itself a raft group.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from tpuraft_torch.rpc.messages import register_message


def _pd(tid: int):
    def deco(cls):
        return register_message(tid, dataclass(cls))
    return deco


@_pd(140)
class ListRegionsRequest:
    pass


@_pd(141)
class ListRegionsResponse:
    regions: list[bytes] = field(default_factory=list)  # Region encodings
    success: bool = True
    redirect: str = ""
    msg: str = ""


@_pd(142)
class ListStoresRequest:
    pass


@_pd(143)
class ListStoresResponse:
    stores: list[bytes] = field(default_factory=list)  # StoreMeta encodings
    success: bool = True
    redirect: str = ""
    msg: str = ""


@_pd(144)
class StoreHeartbeatRequest:
    store_id: int
    endpoint: str
    regions: list[bytes] = field(default_factory=list)  # Region encodings
    # trailing extension (geo): the store's zone label; old senders
    # decode to "" (unlabeled)
    zone: str = ""
    # trailing extension (gray failures): the store's self-reported
    # health level ("healthy"/"degraded"/"sick"; "" = no scoring) —
    # the PD stops placing leaders onto SICK stores and drains them
    health: str = ""


@_pd(145)
class StoreHeartbeatResponse:
    success: bool = True
    redirect: str = ""
    msg: str = ""


@_pd(146)
class RegionHeartbeatRequest:
    region: bytes  # Region encoding
    leader: str    # PeerId string of the region leader
    approximate_keys: int = 0


@_pd(147)
class RegionHeartbeatResponse:
    instructions: list[bytes] = field(default_factory=list)
    success: bool = True
    redirect: str = ""
    msg: str = ""


@_pd(148)
class ReportSplitRequest:
    parent: bytes  # Region encoding
    child: bytes


@_pd(149)
class ReportSplitResponse:
    success: bool = True
    redirect: str = ""
    msg: str = ""


@_pd(150)
class CreateRegionIdRequest:
    pass


@_pd(151)
class CreateRegionIdResponse:
    region_id: int = 0
    success: bool = True
    redirect: str = ""
    msg: str = ""


@_pd(152)
class StoreHeartbeatBatchRequest:
    """Delta-batched PD reporting (quiescent multi-raft): ONE RPC per
    store per interval carrying only CHANGED region rows — an idle
    2K-region store's PD traffic collapses from O(regions) RPCs/s to
    one near-empty batch/s.  ``full=True`` marks a complete resync
    (first contact, or the PD answered ``need_full``)."""

    store_id: int
    endpoint: str
    # changed-region rows, each encode_region_delta() (leader peer,
    # approximate keys, Region encoding)
    deltas: list[bytes] = field(default_factory=list)
    full: bool = False
    # trailing extension (geo): the store's zone label
    zone: str = ""
    # trailing extension (gray failures): self-reported health level
    # ("" = store predates health scoring, treated as healthy)
    health: str = ""
    # trailing extension (fleet observability): packed per-region heat
    # rows (util/heat.encode_heat_rows — region_id + EWMA writes/s,
    # reads/s, bytes in/out per s) for led regions whose heat moved
    # past the noise gate this interval; b"" = nothing moved (zero
    # wire cost) or a pre-heat sender.  Rows are independent of
    # ``deltas``: heat changes at its own cadence.
    heat: bytes = b""
    # trailing extension (fleet observability): tick-plane occupancy —
    # how many region replicas this store hosts and how many of them
    # are hibernating (group quiescence).  The PD folds these into the
    # ClusterView's fleet hibernation fraction.  0/0 = pre-occupancy
    # sender or a timer-mode store that doesn't track it.
    replicas: int = 0
    replicas_quiescent: int = 0


@_pd(153)
class StoreHeartbeatBatchResponse:
    # flat list: each Instruction already names its region_id
    instructions: list[bytes] = field(default_factory=list)
    # the PD leader has no full picture of this store (new leader /
    # store unknown): send a full batch next round
    need_full: bool = False
    success: bool = True
    redirect: str = ""
    msg: str = ""


@_pd(154)
class ClusterDescribeRequest:
    """Fleet observability: ask the PD leader for its folded
    :class:`~tpuraft.rheakv.pd_server.ClusterView` — top-K hot/cold
    regions, per-zone access rates, store health roster, leader
    histograms and the fleet hibernation fraction."""

    top_k: int = 8


@_pd(155)
class ClusterDescribeResponse:
    # JSON rendering of the ClusterView (an admin/read surface: JSON
    # keeps it extensible without wire-schema churn per added field)
    view_json: str = ""
    success: bool = True
    redirect: str = ""
    msg: str = ""


def encode_region_delta(region_blob: bytes, leader: str,
                        approximate_keys: int) -> bytes:
    lp = leader.encode()
    return (struct.pack("<H", len(lp)) + lp
            + struct.pack("<q", approximate_keys) + region_blob)


def decode_region_delta(blob: bytes) -> tuple[bytes, str, int]:
    """Returns (region_encoding, leader, approximate_keys)."""
    (n,) = struct.unpack_from("<H", blob, 0)
    leader = bytes(blob[2:2 + n]).decode()
    (keys,) = struct.unpack_from("<q", blob, 2 + n)
    return bytes(blob[10 + n:]), leader, keys


@_pd(156)
class ReportMergeRequest:
    """Lifecycle plane: a SOURCE region's store reports a completed
    merge (seal + absorb + commit all applied) so the PD finalizes its
    replicated metadata — extend the target's range over the source's,
    drop the source region, clear the pending-merge entry.  This report
    is the ONLY finalization trigger (the target's extended range
    proves the absorb, not that the source's MERGE_COMMIT is durable),
    so it is sent redundantly: by the source leader after commit, by
    every replica at its MERGE_COMMIT apply, and by any store answering
    a re-issued KIND_MERGE for a region it already retired.  Idempotent
    at the PD (the retirement tombstone counts once)."""

    source_region_id: int = 0
    target_region_id: int = 0


@_pd(157)
class ReportMergeResponse:
    success: bool = True
    redirect: str = ""
    msg: str = ""


@dataclass
class Instruction:
    """A PD order to a store (reference: ``rhea:metadata/Instruction`` —
    e.g. RANGE_SPLIT with the new region id)."""

    KIND_SPLIT = 1
    KIND_TRANSFER_LEADER = 2
    # lifecycle plane: merge region_id INTO new_region_id, whose leader
    # (the absorb RPC destination) rides target_peer
    KIND_MERGE = 3
    # lifecycle plane: move region_id's replica src_peer -> target_peer
    # (add-learner, catch up, promote + remove on joint consensus)
    KIND_MOVE = 4

    kind: int = 0
    region_id: int = 0
    new_region_id: int = 0
    target_peer: str = ""
    # trailing extension (KIND_MOVE): the replica being replaced.  Old
    # decoders never see MOVE instructions (a PD only issues them to
    # stores that report moves working), and trailing bytes are safe —
    # each instruction travels as its own length-delimited blob.
    src_peer: str = ""

    def encode(self) -> bytes:
        tp = self.target_peer.encode()
        out = struct.pack("<Bqq", self.kind, self.region_id,
                          self.new_region_id) \
            + struct.pack("<H", len(tp)) + tp
        if self.src_peer:
            sp = self.src_peer.encode()
            out += struct.pack("<H", len(sp)) + sp
        return out

    @staticmethod
    def decode(blob: bytes) -> "Instruction":
        kind, rid, nrid = struct.unpack_from("<Bqq", blob, 0)
        (n,) = struct.unpack_from("<H", blob, 17)
        target = blob[19:19 + n].decode()
        off = 19 + n
        src = ""
        if off + 2 <= len(blob):
            (sn,) = struct.unpack_from("<H", blob, off)
            src = bytes(blob[off + 2:off + 2 + sn]).decode()
        return Instruction(kind, rid, nrid, target, src)


def encode_store_meta(store_id: int, endpoint: str, zone: str = "") -> bytes:
    """Store-meta blob; the zone block is a TRAILING extension written
    only when a zone is set, so zoneless metas keep the old byte format
    and old decoders ignore a labeled meta's tail (each meta travels as
    its own length-delimited blob, so trailing bytes are safe)."""
    ep = endpoint.encode()
    out = struct.pack("<q", store_id) + struct.pack("<H", len(ep)) + ep
    if zone:
        zb = zone.encode()
        out += struct.pack("<H", len(zb)) + zb
    return out


def decode_store_meta(blob: bytes) -> tuple[int, str, str]:
    """Returns (store_id, endpoint, zone); zone defaults to "" for
    pre-zone blobs (tolerant trailing decode)."""
    (sid,) = struct.unpack_from("<q", blob, 0)
    (n,) = struct.unpack_from("<H", blob, 8)
    ep = bytes(blob[10:10 + n]).decode()
    off = 10 + n
    zone = ""
    if off + 2 <= len(blob):
        (zn,) = struct.unpack_from("<H", blob, off)
        zone = bytes(blob[off + 2:off + 2 + zn]).decode()
    return sid, ep, zone
