"""Region / store / cluster metadata.

Reference parity: ``rhea:metadata/*`` — ``Region`` (id, key range,
epoch, peers), ``RegionEpoch`` (confVer bumped on membership change,
version bumped on split/merge), ``Store``, ``Cluster`` (SURVEY.md §3.2
"PD client" row).  Keys are ``bytes``; an empty ``start_key`` means -inf
and an empty ``end_key`` means +inf.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional


@dataclass(order=True)
class RegionEpoch:
    """Staleness fence for routing: requests carry the client's view; the
    server rejects mismatches with INVALID_REGION_EPOCH."""

    conf_ver: int = 1
    version: int = 1

    def copy(self) -> "RegionEpoch":
        return RegionEpoch(self.conf_ver, self.version)


@dataclass
class Region:
    id: int = 0
    start_key: bytes = b""  # inclusive; b"" = -inf
    end_key: bytes = b""    # exclusive; b"" = +inf
    epoch: RegionEpoch = field(default_factory=RegionEpoch)
    peers: list[str] = field(default_factory=list)  # PeerId strings

    def contains_key(self, key: bytes) -> bool:
        if self.start_key and key < self.start_key:
            return False
        if self.end_key and key >= self.end_key:
            return False
        return True

    def contains_range(self, start: bytes, end: bytes) -> bool:
        """True if [start, end) falls entirely inside this region."""
        if self.start_key and start < self.start_key:
            return False
        if self.end_key:
            if not end or end > self.end_key:
                return False
        return True

    def copy(self) -> "Region":
        return Region(self.id, self.start_key, self.end_key,
                      self.epoch.copy(), list(self.peers))

    def encode(self) -> bytes:
        out = bytearray(struct.pack("<qqq", self.id, self.epoch.conf_ver,
                                    self.epoch.version))
        for b in (self.start_key, self.end_key):
            out += struct.pack("<I", len(b)) + b
        out += struct.pack("<H", len(self.peers))
        for p in self.peers:
            pb = p.encode()
            out += struct.pack("<H", len(pb)) + pb
        return bytes(out)

    @staticmethod
    def decode(buf: bytes | memoryview) -> "Region":
        buf = memoryview(buf)
        rid, conf_ver, version = struct.unpack_from("<qqq", buf, 0)
        off = 24
        keys = []
        for _ in range(2):
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            keys.append(bytes(buf[off:off + n]))
            off += n
        (np,) = struct.unpack_from("<H", buf, off)
        off += 2
        peers = []
        for _ in range(np):
            (n,) = struct.unpack_from("<H", buf, off)
            off += 2
            peers.append(bytes(buf[off:off + n]).decode())
            off += n
        return Region(rid, keys[0], keys[1], RegionEpoch(conf_ver, version),
                      peers)

    def __str__(self) -> str:
        return (f"Region[{self.id} [{self.start_key!r}, {self.end_key!r}) "
                f"epoch={self.epoch.conf_ver}.{self.epoch.version}]")


@dataclass
class StoreMeta:
    """One storage process: endpoint + the regions it hosts.

    ``zone`` is the store's failure-domain label (geo deployment):
    the PD spreads leaders across zones and operators place witnesses
    by it.  Empty = unlabeled (single-zone legacy deployments)."""

    id: int = 0
    endpoint: str = ""
    regions: list[Region] = field(default_factory=list)
    zone: str = ""


@dataclass
class ClusterMeta:
    id: int = 0
    name: str = "rheakv"
    stores: list[StoreMeta] = field(default_factory=list)


def region_group_id(cluster_name: str, region_id: int) -> str:
    """groupId convention for a region's raft group (reference:
    ``rhea:JRaftHelper#getJRaftGroupId``: ``clusterName + '-' + regionId``)."""
    return f"{cluster_name}--{region_id}"
