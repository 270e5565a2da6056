"""RegionRouteTable: client-side key-range -> region routing.

Reference parity: ``rhea:RegionRouteTable`` (SURVEY.md §3.2 "Client")
— a sorted range map from region start keys to Region metadata, patched
from INVALID_REGION_EPOCH responses and PD refreshes; plus range → list
of covering regions for multi-region scans.
"""

from __future__ import annotations

import bisect
from typing import Optional

from tpuraft_torch.rheakv.metadata import Region


class RegionRouteTable:
    def __init__(self) -> None:
        self._starts: list[bytes] = []     # sorted region start keys
        self._regions: dict[bytes, Region] = {}
        self._by_id: dict[int, bytes] = {}  # region id -> start key

    def reset(self, regions: list[Region]) -> None:
        self._starts = []
        self._regions = {}
        self._by_id = {}
        for r in regions:
            self.add_or_update(r)

    def add_or_update(self, region: Region) -> None:
        r = region.copy()
        # never regress: a same-id entry with a fresher epoch wins (a
        # lagging replica's ERR_INVALID_EPOCH meta must not overwrite
        # the post-split view — spread reads hit lagging replicas often)
        for old in self._regions.values():
            if old.id == r.id and \
                    (old.epoch.version, old.epoch.conf_ver) > \
                    (r.epoch.version, r.epoch.conf_ver):
                return
        # drop any stale entry for the same region id under a different start
        for start, old in list(self._regions.items()):
            if old.id == r.id and start != r.start_key:
                self._remove_start(start)
        cur = self._regions.get(r.start_key)
        if cur is not None and cur.id != r.id \
                and (cur.epoch.version > r.epoch.version):
            return  # keep the fresher view
        if cur is not None and cur.id != r.id \
                and self._by_id.get(cur.id) == r.start_key:
            del self._by_id[cur.id]   # displaced by a different region
        if r.start_key not in self._regions:
            bisect.insort(self._starts, r.start_key)
        self._regions[r.start_key] = r
        self._by_id[r.id] = r.start_key

    def _remove_start(self, start: bytes) -> None:
        old = self._regions.get(start)
        if old is not None:
            del self._regions[start]
            if self._by_id.get(old.id) == start:
                del self._by_id[old.id]
            i = bisect.bisect_left(self._starts, start)
            if i < len(self._starts) and self._starts[i] == start:
                self._starts.pop(i)

    def remove_region(self, region_id: int) -> None:
        for start, r in list(self._regions.items()):
            if r.id == region_id:
                self._remove_start(start)

    def find_region_by_key(self, key: bytes) -> Optional[Region]:
        """Rightmost region whose start <= key, if key is inside it."""
        i = bisect.bisect_right(self._starts, key) - 1
        if i < 0:
            return None
        r = self._regions[self._starts[i]]
        return r if r.contains_key(key) else None

    def find_region_by_id(self, region_id: int) -> Optional[Region]:
        """O(1) via the id index — this sits on the client's per-round
        re-shard path, where a linear scan is O(regions) per group per
        attempt at density."""
        start = self._by_id.get(region_id)
        if start is None:
            return None
        r = self._regions.get(start)
        return r if r is not None and r.id == region_id else None

    def find_regions_by_range(self, start: bytes, end: bytes) -> list[Region]:
        """All regions intersecting [start, end); ordered by start key."""
        out = []
        i = max(0, bisect.bisect_right(self._starts, start) - 1)
        for s in self._starts[i:]:
            r = self._regions[s]
            if end and r.start_key >= end:
                break
            if r.end_key and r.end_key <= start:
                continue
            out.append(r)
        return out

    def list_regions(self) -> list[Region]:
        return [self._regions[s] for s in self._starts]

    def is_empty(self) -> bool:
        return not self._starts
