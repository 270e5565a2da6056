"""Placement driver server: cluster metadata + region scheduling.

Reference parity: ``pd:DefaultPlacementDriverService`` /
``pd:PlacementDriverServer`` / ``pd:MetadataStore`` /
``pd:ClusterStatsManager`` (SURVEY.md §3.2 "PD server") — the PD is
itself a one-group raft application: store/region heartbeats mutate
replicated metadata; the PD leader answers routing queries and emits
Instructions (RANGE_SPLIT, TRANSFER_LEADER) back to stores.

Determinism note: replicated FSM state holds only logical metadata
(stores, regions, id allocator).  Liveness clocks and split decisions
live on the PD *leader* outside the FSM — they are re-derived after
failover from fresh heartbeats, exactly like the reference's in-memory
ClusterStatsManager.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from dataclasses import dataclass, field
from typing import Optional

from tpuraft_torch.conf import Configuration
from tpuraft_torch.core.node_manager import NodeManager
from tpuraft_torch.core.raft_group_service import RaftGroupService
from tpuraft_torch.core.state_machine import Iterator, StateMachine
from tpuraft_torch.entity import PeerId, Task
from tpuraft_torch.errors import RaftError, Status
from tpuraft_torch.options import NodeOptions
from tpuraft_torch.rheakv.metadata import Region
from tpuraft_torch.rheakv.pd_messages import (
    CreateRegionIdRequest,
    CreateRegionIdResponse,
    Instruction,
    ListRegionsRequest,
    ListRegionsResponse,
    ListStoresRequest,
    ListStoresResponse,
    RegionHeartbeatRequest,
    RegionHeartbeatResponse,
    ReportSplitRequest,
    ReportSplitResponse,
    StoreHeartbeatRequest,
    StoreHeartbeatResponse,
    decode_store_meta,
    encode_store_meta,
)

LOG = logging.getLogger(__name__)

PD_GROUP_ID = "__pd__"

# PD command kinds (the PD group's replicated ops)
_CMD_STORE_UPSERT = 1
_CMD_REGION_UPSERT = 2
_CMD_SPLIT = 3
_CMD_ALLOC_ID = 4
_CMD_SPLIT_ISSUED = 5   # alloc child id + record the pending decision
_CMD_MERGE_ISSUED = 6   # record a pending (source -> target) merge
_CMD_MERGE = 7          # merge completed: fold source into target


def _cmd(kind: int, payload: bytes = b"") -> bytes:
    return struct.pack("<B", kind) + payload


@dataclass
class _StoreRecord:
    store_id: int
    endpoint: str
    zone: str = ""   # geo failure-domain label ("" = unlabeled)


def _peer_endpoint(peer_str: str) -> str:
    """Peer string ('ip:port[:idx[:prio]][/learner|/witness]') -> endpoint."""
    return ":".join(peer_str.split("/", 1)[0].split(":")[:2])


def zone_leader_histogram(region_leaders: dict[int, str],
                          zones: dict[str, str]) -> dict[str, int]:
    """Leaders per zone — computed ONCE per heartbeat batch and shared
    across every pick_transfer_target call in the request."""
    counts: dict[str, int] = {}
    for ep in region_leaders.values():
        z = zones.get(_peer_endpoint(ep), "")
        counts[z] = counts.get(z, 0) + 1
    return counts


class PDMetadataFSM(StateMachine):
    """Replicated PD state: stores, regions, region-id allocator."""

    def __init__(self) -> None:
        self.stores: dict[str, _StoreRecord] = {}   # endpoint -> record
        self.regions: dict[int, Region] = {}
        self.region_leaders: dict[int, str] = {}
        self.next_region_id: int = 1024  # user regions allocate upward
        # REPLICATED split decisions (VERDICT r1 #8): parent region ->
        # allocated child id.  A PD failover must not re-decide a split
        # that was already ordered — the new leader re-issues the SAME
        # child id (idempotent at the store) instead of allocating a
        # duplicate.  Cleared when the split is reported done.
        self.pending_splits: dict[int, int] = {}
        # REPLICATED merge decisions (lifecycle plane, same failover
        # argument): source region -> target region.  The new PD leader
        # re-issues the SAME pair until the merge completes — a merge
        # is a multi-step store-side protocol and must never be
        # half-forgotten or re-decided against a different neighbor.
        self.pending_merges: dict[int, int] = {}
        # REPLICATED merge tombstones: retired source region -> the
        # target that absorbed it.  A full resync from the (now
        # retiring) source leader can still carry the dead region's
        # row; without the tombstone that upsert would resurrect it in
        # the PD view and double-cover the keyspace.  Bounded by the
        # merge count (region ids are never reused).
        self.retired_regions: dict[int, int] = {}

    async def on_apply(self, it: Iterator) -> None:
        while it.valid():
            data = it.data()
            done = it.done()
            result = None
            try:
                result = self._dispatch(data)
                status = Status.OK()
            except Exception as e:  # noqa: BLE001
                LOG.exception("pd apply failed")
                status = Status.error(RaftError.ESTATEMACHINE, str(e))
            if done is not None:
                if hasattr(done, "result"):
                    done.result = result
                done(status)
            it.next()

    def _dispatch(self, data: bytes):
        (kind,) = struct.unpack_from("<B", data, 0)
        payload = data[1:]
        if kind == _CMD_STORE_UPSERT:
            sid, ep, zone = decode_store_meta(payload)
            self.stores[ep] = _StoreRecord(sid, ep, zone)
            return True
        if kind == _CMD_REGION_UPSERT:
            (ln,) = struct.unpack_from("<H", payload, 0)
            leader = payload[2:2 + ln].decode()
            region = Region.decode(payload[2 + ln:])
            if region.id in self.retired_regions:
                return True  # merged away: never resurrect
            cur = self.regions.get(region.id)
            if cur is None or (region.epoch.version, region.epoch.conf_ver) \
                    >= (cur.epoch.version, cur.epoch.conf_ver):
                self.regions[region.id] = region
                if leader:
                    self.region_leaders[region.id] = leader
            return True
        if kind == _CMD_SPLIT_ISSUED:
            (parent_id,) = struct.unpack_from("<q", payload, 0)
            already = self.pending_splits.get(parent_id)
            if already is not None:
                return already  # idempotent: same child id re-issued
            rid = self.next_region_id
            self.next_region_id += 1
            self.pending_splits[parent_id] = rid
            return rid
        if kind == _CMD_SPLIT:
            (pn,) = struct.unpack_from("<I", payload, 0)
            parent = Region.decode(payload[4:4 + pn])
            child = Region.decode(payload[4 + pn:])
            # clear only the MATCHING decision: a stale replayed report
            # (client retry) must not erase a newer pending split
            if self.pending_splits.get(parent.id) == child.id:
                self.pending_splits.pop(parent.id, None)
            # epoch-guarded like _CMD_REGION_UPSERT: a replayed
            # report_split (client retry after a lost response) must not
            # stomp fresher metadata from heartbeats or a later split —
            # and, like the heartbeat path, must never RESURRECT a
            # region that has since merged away (a re-issued split
            # instruction makes the store re-report an old split long
            # after both halves may have gone cold and been absorbed;
            # cur is None after the tombstone pop, so without this
            # check the stale mint-era record would land unguarded and
            # overlap the absorber's extended range)
            for region in (parent, child):
                if region.id in self.retired_regions:
                    continue
                cur = self.regions.get(region.id)
                if cur is None or (region.epoch.version,
                                   region.epoch.conf_ver) >= \
                        (cur.epoch.version, cur.epoch.conf_ver):
                    self.regions[region.id] = region
            self.next_region_id = max(self.next_region_id, child.id + 1)
            return True
        if kind == _CMD_MERGE_ISSUED:
            src_id, tgt_id = struct.unpack_from("<qq", payload, 0)
            already = self.pending_merges.get(src_id)
            if already is not None:
                return already  # idempotent: same target re-issued
            self.pending_merges[src_id] = tgt_id
            return tgt_id
        if kind == _CMD_MERGE:
            from tpuraft_torch.rheakv.state_machine import extend_region_over

            src_id, tgt_id = struct.unpack_from("<qq", payload, 0)
            src = self.regions.pop(src_id, None)
            self.region_leaders.pop(src_id, None)
            tgt = self.regions.get(tgt_id)
            if src is not None and tgt is not None:
                # same deterministic extension the target replicas ran
                # (idempotent: a heartbeat may have upserted the
                # already-extended target first).  NEVER throw out of
                # on_apply: a non-adjacent pair (a policy bug, or
                # metadata skew from a stale report) must degrade to a
                # logged violation, not crash the apply loop on every
                # PD replica — the next target heartbeat re-upserts the
                # true range either way.
                try:
                    extend_region_over(tgt, src.start_key, src.end_key)
                except RuntimeError:
                    LOG.error(
                        "merge finalize %d -> %d: source range "
                        "[%r, %r) not adjacent to target [%r, %r); "
                        "keyspace left to heartbeat repair", src_id,
                        tgt_id, src.start_key, src.end_key,
                        tgt.start_key, tgt.end_key)
            if self.pending_merges.get(src_id) == tgt_id:
                self.pending_merges.pop(src_id, None)
            # True only for the FIRST finalization of this source: the
            # report-RPC path and the heartbeat finalization arm can
            # race the same merge through here, and both count from
            # this return value (replicated state is the tiebreak)
            fresh = src_id not in self.retired_regions
            self.retired_regions[src_id] = tgt_id
            return fresh
        if kind == _CMD_ALLOC_ID:
            rid = self.next_region_id
            self.next_region_id += 1
            return rid
        raise ValueError(f"unknown pd cmd {kind}")

    # -- snapshot ------------------------------------------------------------

    async def on_snapshot_save(self, writer, done) -> None:
        out = bytearray(struct.pack("<q", self.next_region_id))
        out += struct.pack("<I", len(self.stores))
        for rec in self.stores.values():
            out += encode_store_meta(rec.store_id, rec.endpoint)
        out += struct.pack("<I", len(self.regions))
        for rid, region in self.regions.items():
            blob = region.encode()
            leader = self.region_leaders.get(rid, "").encode()
            out += struct.pack("<I", len(blob)) + blob
            out += struct.pack("<H", len(leader)) + leader
        out += struct.pack("<I", len(self.pending_splits))
        for parent_id, child_id in self.pending_splits.items():
            out += struct.pack("<qq", parent_id, child_id)
        # trailing (geo zones) — absent in pre-zone snapshots; store
        # records above stay in the legacy zoneless format so old
        # readers parse the stream unchanged
        zoned = [(ep, rec.zone) for ep, rec in self.stores.items()
                 if rec.zone]
        out += struct.pack("<I", len(zoned))
        for ep, zone in zoned:
            epb, zb = ep.encode(), zone.encode()
            out += struct.pack("<H", len(epb)) + epb
            out += struct.pack("<H", len(zb)) + zb
        # trailing (lifecycle plane) — absent in pre-merge snapshots
        out += struct.pack("<I", len(self.pending_merges))
        for src_id, tgt_id in self.pending_merges.items():
            out += struct.pack("<qq", src_id, tgt_id)
        out += struct.pack("<I", len(self.retired_regions))
        for src_id, tgt_id in self.retired_regions.items():
            out += struct.pack("<qq", src_id, tgt_id)
        writer.write_file("pd_meta", bytes(out))
        done(Status.OK())

    async def on_snapshot_load(self, reader) -> bool:
        blob = reader.read_file("pd_meta")
        if blob is None:
            return False
        buf = memoryview(blob)
        (self.next_region_id,) = struct.unpack_from("<q", buf, 0)
        off = 8
        (ns,) = struct.unpack_from("<I", buf, off)
        off += 4
        self.stores = {}
        for _ in range(ns):
            (sid,) = struct.unpack_from("<q", buf, off)
            off += 8
            (n,) = struct.unpack_from("<H", buf, off)
            off += 2
            ep = bytes(buf[off:off + n]).decode()
            off += n
            self.stores[ep] = _StoreRecord(sid, ep)
        (nr,) = struct.unpack_from("<I", buf, off)
        off += 4
        self.regions = {}
        self.region_leaders = {}
        for _ in range(nr):
            (bn,) = struct.unpack_from("<I", buf, off)
            off += 4
            region = Region.decode(buf[off:off + bn])
            off += bn
            (ln,) = struct.unpack_from("<H", buf, off)
            off += 2
            leader = bytes(buf[off:off + ln]).decode()
            off += ln
            self.regions[region.id] = region
            if leader:
                self.region_leaders[region.id] = leader
        self.pending_splits = {}
        if off + 4 <= len(buf):  # absent in pre-pending-split snapshots
            (np_,) = struct.unpack_from("<I", buf, off)
            off += 4
            for _ in range(np_):
                parent_id, child_id = struct.unpack_from("<qq", buf, off)
                off += 16
                self.pending_splits[parent_id] = child_id
        if off + 4 <= len(buf):  # absent in pre-zone snapshots
            (nz,) = struct.unpack_from("<I", buf, off)
            off += 4
            for _ in range(nz):
                (en,) = struct.unpack_from("<H", buf, off)
                off += 2
                ep = bytes(buf[off:off + en]).decode()
                off += en
                (zn,) = struct.unpack_from("<H", buf, off)
                off += 2
                zone = bytes(buf[off:off + zn]).decode()
                off += zn
                if ep in self.stores:
                    self.stores[ep].zone = zone
        self.pending_merges = {}
        if off + 4 <= len(buf):  # absent in pre-merge snapshots
            (nm,) = struct.unpack_from("<I", buf, off)
            off += 4
            for _ in range(nm):
                src_id, tgt_id = struct.unpack_from("<qq", buf, off)
                off += 16
                self.pending_merges[src_id] = tgt_id
        self.retired_regions = {}
        if off + 4 <= len(buf):  # absent in pre-merge snapshots
            (nt,) = struct.unpack_from("<I", buf, off)
            off += 4
            for _ in range(nt):
                src_id, tgt_id = struct.unpack_from("<qq", buf, off)
                off += 16
                self.retired_regions[src_id] = tgt_id
        return True


@dataclass
class RegionStats:
    """ONE region-stats record per region — the unified intake the PD
    split policy reads.  Key counts (the legacy ``approximate_keys``
    path) and heat rates (the fleet observability plane) land in the
    SAME record, so ``should_split`` — and item 2's heat-driven
    split/merge/move policy after it — has one place to look."""

    keys: int = 0
    writes_s: float = 0.0
    reads_s: float = 0.0
    bytes_in_s: float = 0.0
    bytes_out_s: float = 0.0
    # monotonic stamp of the last heat intake (0.0 = keys-only entry);
    # the staleness sweep zeroes rates whose reporter went silent — a
    # moved/evacuated leadership must not leave hot rates behind forever
    heat_at: float = 0.0

    @property
    def score(self) -> float:
        from tpuraft_torch.util.heat import heat_score

        return heat_score(self.writes_s, self.reads_s,
                          self.bytes_in_s, self.bytes_out_s)


# graftcheck: loop-confined — every intake/policy path (heartbeat
# handlers, the staleness sweep, balancing) runs on the PD node's RPC
# loop; the metrics HTTP thread reads SNAPSHOT copies only (render
# methods list()/copy live dicts before iterating — the PR 13 rule)
class ClusterStatsManager:
    """Leader-side (non-replicated) stats: per-region key counts + heat
    rates (ONE record per region — see :class:`RegionStats`) and
    split/transfer decisions.

    Reference: ``pd:ClusterStatsManager`` — finds the region with the
    most keys above the split threshold; extended here with the heat
    intake the heartbeats report, top-K hot/cold ranking for the
    ClusterView, and hot-region detection (a region whose score crosses
    the fleet's heat percentile fires a ``hot_region`` flight-recorder
    event — the exact signal a split/move policy consumes).
    """

    # hot-region detection: a region is HOT when its score exceeds
    # max(hot_min_score, hot_factor x the fleet's BACKGROUND percentile
    # — the median, NOT a tail percentile: in a small fleet the hot
    # regions ARE the tail, so anchoring on p90 would set the bar at
    # 4x the hot set's own score and unflag exactly the regions the
    # detector exists to find); it cools at half the threshold
    # (hysteresis, no event flapping).  Below ``hot_min_population``
    # scored regions the threshold is undefined (infinity): a
    # half-reported bootstrap fleet must not mass-flag on a floor
    # computed from the first few rows.
    hot_percentile = 50.0
    hot_factor = 4.0
    hot_min_score = 2.0
    hot_min_population = 8
    # rates not re-reported for this long are zeroed by the sweep
    # (leadership moved and the new leader's heat sits under the noise
    # gate, or the region left the fleet) — keys are kept, matching
    # the legacy keys-only intake which never expired either
    heat_stale_s = 30.0

    def __init__(self, split_threshold_keys: int) -> None:
        self.split_threshold_keys = split_threshold_keys
        self._stats: dict[int, RegionStats] = {}
        self._inflight_splits: dict[int, float] = {}  # region -> deadline
        self._transfer_cooldown: dict[int, float] = {}  # region -> deadline
        # region -> (from_ep, to_ep, expiry): ordered but not yet
        # observed in region_leaders (overlaid onto balancing counts)
        self._pending_moves: dict[int, tuple[str, str, float]] = {}
        self._leader_term = -1      # last PD term balancing ran under
        self._grace_until = 0.0     # post-failover balancing pause
        # hot-region state: currently-hot set + cached threshold (the
        # percentile scan is O(regions), so it refreshes at most once
        # per second, not per intake row; None = undefined — heated
        # population below hot_min_population)
        self._hot: set[int] = set()
        self._hot_threshold: Optional[float] = None
        self._hot_recalc_at = 0.0
        self.hot_events = 0

    def note_leadership(self, term: int, cooldown_s: float) -> None:
        """Deterministic cooldown rebuild on PD leadership change
        (VERDICT r2 #9): cooldowns and pending moves are leader-local,
        so a new leader cannot know which transfers its predecessor
        ordered seconds ago — instead EVERY region starts the new term
        on one full cooldown, making an immediate re-transfer of a
        just-moved region structurally impossible."""
        if term == self._leader_term:
            return
        self._leader_term = term
        # graftcheck: allow(raw-clock) — PD-side post-failover grace window (real time)
        self._grace_until = time.monotonic() + cooldown_s
        self._transfer_cooldown.clear()
        self._pending_moves.clear()

    def _ent(self, region_id: int) -> RegionStats:
        ent = self._stats.get(region_id)
        if ent is None:
            ent = self._stats[region_id] = RegionStats()
        return ent

    def record(self, region_id: int, approximate_keys: int) -> None:
        self._ent(region_id).keys = approximate_keys

    def record_heat(self, region_id: int, writes_s: float, reads_s: float,
                    bytes_in_s: float, bytes_out_s: float) -> None:
        """Heat intake (heartbeat trailing field) into the SAME record
        the split policy reads; fires the hot_region detector."""
        ent = self._ent(region_id)
        ent.writes_s = writes_s
        ent.reads_s = reads_s
        ent.bytes_in_s = bytes_in_s
        ent.bytes_out_s = bytes_out_s
        # graftcheck: allow(raw-clock) — PD-side heat-report age stamp (real time)
        ent.heat_at = time.monotonic()
        self._note_hot(region_id, ent.score)

    def _note_hot(self, region_id: int, score: float) -> None:
        from tpuraft_torch.util.trace import RECORDER

        self.maybe_sweep()
        thr = self._hot_threshold
        if thr is None:
            # threshold undefined (heated population below the gate):
            # flag nothing new AND cool nothing — standing flags must
            # not flap on a population-count transient
            return
        if region_id in self._hot:
            if score < thr / 2.0:
                self._hot.discard(region_id)
            return
        if score >= thr:
            self._hot.add(region_id)
            self.hot_events += 1
            # coalesced: a hotspot shift can re-flag a whole shard
            # family inside one heartbeat burst
            RECORDER.record_coalesced(
                "hot_region", str(region_id),
                score=round(score, 2), threshold=round(thr, 2))

    def maybe_sweep(self) -> None:
        """Run the staleness/threshold sweep if one is due (rate-bound
        to 1/s); called from heat intake AND from the view build, so a
        fleet that went silent still ages its standing rates out."""
        # graftcheck: allow(raw-clock) — PD-side heat staleness sweep (real time)
        now = time.monotonic()
        if now >= self._hot_recalc_at:
            self._hot_sweep(now)

    def _hot_sweep(self, now: float) -> None:
        """At most once per second: zero stale heat (a silent reporter
        must not leave standing rates in the view or the percentile
        base), refresh the threshold, and re-judge every currently
        flagged region against it — cooling must not wait for an
        intake row the noise gate may never send."""
        self._hot_recalc_at = now + 1.0
        stale = now - self.heat_stale_s
        heated = 0
        for ent in self._stats.values():
            if ent.heat_at <= 0.0:
                continue
            if ent.heat_at < stale:
                ent.writes_s = ent.reads_s = 0.0
                ent.bytes_in_s = ent.bytes_out_s = 0.0
                ent.heat_at = 0.0
            else:
                heated += 1
        if heated < self.hot_min_population:
            # undefined: too few live reporters to anchor a background
            # percentile.  No new flags, and LIVE standing flags stand
            # — a brief reporter dropout must not erase (then re-fire)
            # them; only flags whose own reporter went stale cool
            # (their rates were just zeroed — we know nothing anymore)
            self._hot_threshold = None
            for rid in list(self._hot):
                ent = self._stats.get(rid)
                if ent is None or ent.heat_at <= 0.0:
                    self._hot.discard(rid)
            return
        self._hot_threshold = max(
            self.hot_min_score,
            self.hot_factor * self._score_percentile(
                self.hot_percentile))
        for rid in list(self._hot):
            ent = self._stats.get(rid)
            if ent is None or ent.score < self._hot_threshold / 2.0:
                self._hot.discard(rid)

    def _score_percentile(self, p: float) -> float:
        """Nearest-rank percentile over the heated regions' scores
        (keys-only entries carry no load information and would drag
        the background estimate to zero)."""
        import math

        scores = sorted(ent.score for ent in self._stats.values()
                        if ent.heat_at > 0.0)
        if not scores:
            return 0.0
        idx = max(0, min(len(scores) - 1,
                         math.ceil(p / 100.0 * len(scores)) - 1))
        return scores[idx]

    def drop(self, region_id: int) -> None:
        """Region left the fleet (merged away): forget its stats so the
        cold ranking and hot set stop listing a dead id."""
        self._stats.pop(region_id, None)
        self._inflight_splits.pop(region_id, None)
        self._transfer_cooldown.pop(region_id, None)
        self._pending_moves.pop(region_id, None)
        self._hot.discard(region_id)

    def hot_regions(self) -> set[int]:
        return set(self._hot)

    def hot_count(self) -> int:
        """Flagged-region count via len() (GIL-atomic) — safe from the
        metrics exposition thread, unlike copying the live set."""
        return len(self._hot)

    def region_stats(self, region_id: int) -> RegionStats:
        return self._stats.get(region_id) or RegionStats()

    def top_hot(self, k: int) -> list[tuple[int, RegionStats]]:
        """Hottest k regions by score, descending (zero-score regions
        excluded — a silent fleet has no hot regions)."""
        return sorted(((rid, ent) for rid, ent in self._stats.items()
                       if ent.score > 0.0),
                      key=lambda kv: -kv[1].score)[:max(0, k)]

    def top_cold(self, k: int) -> list[tuple[int, RegionStats]]:
        """Coldest k regions by score, ascending — merge candidates."""
        return sorted(self._stats.items(),
                      key=lambda kv: kv[1].score)[:max(0, k)]

    def last_keys(self, region_id: int) -> int:
        """Last reported key count (delta-batched stores skip unchanged
        regions, so the policy pass reads the standing estimate)."""
        ent = self._stats.get(region_id)
        return ent.keys if ent is not None else 0

    def split_pacing_ok(self, region_id: int) -> bool:
        """Split pacing gate shared by the key-count path and the
        lifecycle plane's heat-driven path: False while a split of this
        region is in flight / cooling down."""
        # graftcheck: allow(raw-clock) — PD-side split cooldown window (real time)
        now = time.monotonic()
        self._inflight_splits = {r: d for r, d in
                                 self._inflight_splits.items() if d > now}
        return region_id not in self._inflight_splits

    def should_split(self, region_id: int) -> bool:
        if self.split_threshold_keys <= 0:
            return False
        if not self.split_pacing_ok(region_id):
            return False
        return self.last_keys(region_id) >= self.split_threshold_keys

    def mark_split_issued(self, region_id: int, cooldown_s: float = 30.0
                          ) -> None:
        # graftcheck: allow(raw-clock) — PD-side split cooldown window (real time)
        self._inflight_splits[region_id] = time.monotonic() + cooldown_s
        ent = self._stats.get(region_id)
        if ent is not None:
            # keys reset (the split empties the parent's estimate); the
            # heat rates stay — load keeps landing until clients re-route
            ent.keys = 0

    # -- leader balancing (reference: ClusterStatsManager's busiest-store
    # accounting feeding rebalance) ------------------------------------

    def pick_transfer_target(self, region: Region, leader_ep: str,
                             region_leaders: dict[int, str],
                             cooldown_s: float,
                             zones: Optional[dict[str, str]] = None,
                             zone_counts: Optional[dict[str, int]] = None,
                             health: Optional[dict[str, str]] = None
                             ) -> Optional[str]:
        """If ``leader_ep`` leads at least 2 more regions than the
        least-loaded peer of ``region``, return that peer as the
        transfer target (with a per-region cooldown so one imbalance
        doesn't spray repeated transfers).  Ties between equally-loaded
        targets break FIRST on zone leader counts when store zone
        labels are known (``zones``: endpoint -> zone) — leaders spread
        across failure domains, not just across stores — then on a
        per-region hash so concurrent decisions spread across stores
        instead of herding onto the first one.  Witness replicas
        (``/witness``-suffixed peers) can never lead and are never
        targets, like learners.

        Decisions overlay the PENDING moves this manager already
        ordered but has not yet observed in ``region_leaders`` —
        without that, one heartbeat burst sees the same stale counts
        for every region and orders the whole imbalance moved at once,
        overshooting into a permanent oscillation (observed as
        (6,0,0) → (0,2,4) → (2,4,0) → ... thrash every cooldown
        period).

        Gray failures (``health``: endpoint -> self-reported level):
        a SICK store is never a transfer TARGET (moving leadership onto
        a gray store helps nobody), DEGRADED stores lose ties, and a
        SICK *leader* is DRAINED — the least-loaded healthy peer is
        picked even when the usual >=2 leader-count imbalance is
        absent (cooldown and post-failover grace still pace it)."""
        # graftcheck: allow(raw-clock) — PD-side cooldown pacing; the PD is not a store and has no injected clock
        now = time.monotonic()
        if now < self._grace_until:
            return None  # post-failover grace (note_leadership)
        self._transfer_cooldown = {
            r: d for r, d in self._transfer_cooldown.items() if d > now}
        self._pending_moves = {
            r: m for r, m in self._pending_moves.items()
            if m[2] > now and region_leaders.get(r) != m[1]}
        if region.id in self._transfer_cooldown:
            return None
        counts: dict[str, int] = {}
        for _, ep in region_leaders.items():
            counts[ep] = counts.get(ep, 0) + 1
        # overlay in-flight moves: the source already "lost" the lease,
        # the destination already "gained" it
        for rid, (src, dst, _) in self._pending_moves.items():
            if region_leaders.get(rid) == src:
                counts[src] = counts.get(src, 0) - 1
                counts[dst] = counts.get(dst, 0) + 1
        my = counts.get(leader_ep, 0)
        health = health or {}
        _H_RANK = {"": 0, "healthy": 0, "degraded": 1, "sick": 2}

        def h_rank(p: str) -> int:
            return _H_RANK.get(health.get(_peer_endpoint(p), ""), 0)

        leader_sick = health.get(_peer_endpoint(leader_ep), "") == "sick"
        # learners are read-only replicas and witnesses hold no payload
        # — neither can lead, so neither is a leadership target; a SICK
        # store is excluded too (never place leaders onto gray stores)
        candidates = [p for p in region.peers
                      if p != leader_ep and not p.endswith("/learner")
                      and not p.endswith("/witness")
                      and h_rank(p) < 2]
        if not candidates:
            return None
        if zones and zone_counts is None:
            # single-region path builds its own histogram; the BATCH
            # heartbeat precomputes it once per request (an O(regions)
            # scan here per region made the batch pass O(regions^2))
            zone_counts = zone_leader_histogram(region_leaders, zones)

        def zone_load(p: str) -> int:
            if not zones:
                return 0
            return zone_counts.get(zones.get(_peer_endpoint(p), ""), 0)

        target = min(candidates,
                     key=lambda p: (h_rank(p), counts.get(p, 0),
                                    zone_load(p),
                                    hash((region.id, p)) & 0xffff))
        if not leader_sick and my - counts.get(target, 0) < 2:
            return None
        self._transfer_cooldown[region.id] = now + cooldown_s
        self._pending_moves[region.id] = (
            leader_ep, target, now + 2 * cooldown_s)
        return target


@dataclass
class PlacementDriverOptions:
    endpoints: list[str] = field(default_factory=list)  # PD cluster peers
    election_timeout_ms: int = 1000
    data_path: str = ""
    # emit a RANGE_SPLIT instruction when a region reports >= this many
    # keys (0 disables auto-split)
    split_threshold_keys: int = 0
    # emit TRANSFER_LEADER instructions to even out per-store leader
    # counts (reference: CliServiceImpl#rebalance driven by PD stats)
    balance_leaders: bool = False
    # per-region pause between ordered transfers, so one imbalance
    # doesn't spray repeated TRANSFER_LEADER at a region mid-move
    transfer_cooldown_s: float = 5.0
    initial_regions: list[Region] = field(default_factory=list)
    # fleet observability: serve PD-side Prometheus text at GET
    # /metrics on the PD's OWN stdlib listener (None = off, 0 =
    # ephemeral — the bound port lands in
    # PlacementDriverServer.metrics_http_port, N = that port).  The
    # same render answers the ``pd_describe_metrics`` RPC regardless.
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    # -- region lifecycle engine (ISSUE 20) ----------------------------------
    # master switch: run the placement policy (heat-driven splits, cold
    # merges, cross-store moves) over the heartbeat stream.  The policy
    # itself lives in tpuraft/rheakv/placement.py; the knobs below
    # mirror LifecycleOptions.
    lifecycle: bool = False
    lifecycle_heat_split_min_keys: int = 32
    lifecycle_merge_max_score: float = 0.05
    lifecycle_merge_max_keys: int = 4096
    lifecycle_merge_cooldown_s: float = 10.0
    lifecycle_max_inflight_merges: int = 2
    lifecycle_min_regions: int = 4
    lifecycle_move_imbalance: int = 2
    lifecycle_move_cooldown_s: float = 10.0
    lifecycle_max_inflight_moves: int = 2


class PlacementDriverServer:
    """One PD cluster member: raft node + pd_* RPC processors."""

    def __init__(self, opts: PlacementDriverOptions, server_id: str,
                 rpc_server, transport) -> None:
        self.opts = opts
        self.server_id = PeerId.parse(server_id)
        self.rpc_server = rpc_server
        self.transport = transport
        self.node_manager = NodeManager(rpc_server)
        self.fsm = PDMetadataFSM()
        self.stats = ClusterStatsManager(opts.split_threshold_keys)
        # region lifecycle engine (ISSUE 20): the policy half lives in
        # placement.py; None = lifecycle off (legacy PD behavior)
        self.placement = None
        if opts.lifecycle:
            from tpuraft_torch.rheakv.placement import (LifecycleOptions,
                                                  PlacementEngine)

            self.placement = PlacementEngine(LifecycleOptions(
                heat_split_min_keys=opts.lifecycle_heat_split_min_keys,
                merge_max_score=opts.lifecycle_merge_max_score,
                merge_max_keys=opts.lifecycle_merge_max_keys,
                merge_cooldown_s=opts.lifecycle_merge_cooldown_s,
                max_inflight_merges=opts.lifecycle_max_inflight_merges,
                min_regions=opts.lifecycle_min_regions,
                move_imbalance=opts.lifecycle_move_imbalance,
                move_cooldown_s=opts.lifecycle_move_cooldown_s,
                max_inflight_moves=opts.lifecycle_max_inflight_moves))
        self._merge_pick_lock = asyncio.Lock()
        self._group: Optional[RaftGroupService] = None
        for method, handler in [
            ("pd_list_regions", self._list_regions),
            ("pd_list_stores", self._list_stores),
            ("pd_store_heartbeat", self._store_heartbeat),
            ("pd_region_heartbeat", self._region_heartbeat),
            ("pd_store_heartbeat_batch", self._store_heartbeat_batch),
            ("pd_report_split", self._report_split),
            ("pd_report_merge", self._report_merge),
            ("pd_create_region_id", self._create_region_id),
            ("pd_cluster_describe", self._cluster_describe),
            ("pd_describe_metrics", self._describe_metrics),
        ]:
            rpc_server.register(method, handler)
        # delta-batch protocol state (leader-local, like ClusterStats):
        # store endpoint -> PD term of the last FULL batch seen.  A new
        # PD leader's stats are cold, so it answers need_full until each
        # store resyncs — deltas alone can't rebuild the key counts its
        # split/balance decisions read.
        self._batch_synced: dict[str, int] = {}
        # gray-failure state (leader-local, ephemeral like ClusterStats
        # — re-derived from heartbeats after failover): store endpoint
        # -> self-reported health level ("healthy"/"degraded"/"sick")
        self._store_health: dict[str, str] = {}
        # tick-plane occupancy (leader-local, from heartbeat trailing
        # fields): store endpoint -> (replicas, replicas_quiescent);
        # folded into the ClusterView's fleet hibernation fraction
        self._store_occupancy: dict[str, tuple[int, int]] = {}
        # fleet-observability counters (pd_describe_metrics / HTTP)
        self.hb_rpcs = 0            # legacy per-store heartbeats
        self.hb_region_rpcs = 0     # legacy per-region heartbeats
        self.hb_batch_rpcs = 0      # delta-batched heartbeats
        self.hb_delta_rows = 0      # region delta rows carried
        self.hb_heat_rows = 0       # heat rows carried
        self.splits_ordered = 0
        self.transfers_ordered = 0
        self.cluster_describes = 0
        # lifecycle counters (the soak exit gate + admin plane read
        # these; heat_splits_ordered also counts into splits_ordered)
        self.heat_splits_ordered = 0
        self.merges_ordered = 0       # KIND_MERGE instructions issued
        self.merges_completed = 0     # _CMD_MERGE finalized
        self.moves_ordered = 0        # KIND_MOVE instructions issued
        self._metrics_httpd = None
        self.metrics_http_port: Optional[int] = None

    @property
    def node(self):
        return self._group.node if self._group else None

    async def start(self) -> None:
        node_opts = NodeOptions(
            election_timeout_ms=self.opts.election_timeout_ms,
            initial_conf=Configuration.parse(",".join(self.opts.endpoints)),
            fsm=self.fsm,
        )
        if self.opts.data_path:
            base = (f"{self.opts.data_path}/pd_"
                    f"{self.server_id.ip}_{self.server_id.port}")
            node_opts.log_uri = f"file://{base}/log"
            node_opts.raft_meta_uri = f"file://{base}/meta"
            node_opts.snapshot_uri = f"file://{base}/snapshot"
        else:
            node_opts.log_uri = "memory://"
            node_opts.raft_meta_uri = "memory://"
        self._group = RaftGroupService(
            PD_GROUP_ID, self.server_id, node_opts, self.node_manager,
            self.transport)
        node = await self._group.start()
        # seed the initial region layout once the PD leader emerges
        if self.opts.initial_regions:
            self._seed_regions = list(self.opts.initial_regions)
        else:
            self._seed_regions = []
        if self.opts.metrics_port is not None:
            from tpuraft_torch.util.metrics_http import MetricsHttpServer

            self._metrics_httpd = MetricsHttpServer(
                self.opts.metrics_host, self.opts.metrics_port,
                self.metrics_text,
                name=f"pd-metrics-http-{self.server_id}")
            self.metrics_http_port = self._metrics_httpd.port

    async def shutdown(self) -> None:
        if self._metrics_httpd is not None:
            import asyncio

            httpd = self._metrics_httpd
            self._metrics_httpd = None
            await asyncio.get_running_loop().run_in_executor(
                None, httpd.shutdown_blocking)
        if self._group:
            await self._group.shutdown()
            self._group = None

    # -- raft plumbing -------------------------------------------------------

    def _not_leader(self, resp_cls):
        leader = self.node.get_leader_id() if self.node else None
        redirect = ""
        if leader is not None and not leader.is_empty():
            redirect = leader.endpoint
        return resp_cls(success=False, redirect=redirect, msg="not PD leader")

    async def _apply(self, data: bytes):
        import asyncio

        fut = asyncio.get_running_loop().create_future()

        class _Done:
            result = None

            def __call__(self, status: Status) -> None:
                if not fut.done():
                    fut.set_result((status, self.result))

        await self.node.apply(Task(data=data, done=_Done()))
        status, result = await fut
        if not status.is_ok():
            raise RuntimeError(str(status))
        return result

    async def _maybe_seed(self) -> None:
        """Replicate the initial region layout once (leader, first contact)."""
        if not self._seed_regions or not self.fsm or self.fsm.regions:
            return
        for region in self._seed_regions:
            payload = struct.pack("<H", 0) + region.encode()
            await self._apply(_cmd(_CMD_REGION_UPSERT, payload))
        self._seed_regions = []

    # -- processors ----------------------------------------------------------

    async def _list_regions(self, req: ListRegionsRequest
                            ) -> ListRegionsResponse:
        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(ListRegionsResponse)
        await self._maybe_seed()
        await node.read_index()
        return ListRegionsResponse(
            regions=[r.encode() for r in self.fsm.regions.values()])

    async def _list_stores(self, req: ListStoresRequest) -> ListStoresResponse:
        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(ListStoresResponse)
        await node.read_index()
        return ListStoresResponse(
            stores=[encode_store_meta(r.store_id, r.endpoint, r.zone)
                    for r in self.fsm.stores.values()])

    def _region_changed(self, region: Region, leader: str = "") -> bool:
        cur = self.fsm.regions.get(region.id)
        if cur is None:
            return True
        if (cur.epoch.conf_ver, cur.epoch.version,
                cur.start_key, cur.end_key, cur.peers) != \
                (region.epoch.conf_ver, region.epoch.version,
                 region.start_key, region.end_key, region.peers):
            return True
        return bool(leader) and \
            self.fsm.region_leaders.get(region.id) != leader

    async def _store_heartbeat(self, req: StoreHeartbeatRequest
                               ) -> StoreHeartbeatResponse:
        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(StoreHeartbeatResponse)
        self.hb_rpcs += 1
        await self._maybe_seed()
        # only replicate *changes* — heartbeats repeat at 1s cadence and
        # must not grow the PD log when nothing moved
        zone = getattr(req, "zone", "")
        self._note_store_health(req.endpoint, getattr(req, "health", ""))
        cur = self.fsm.stores.get(req.endpoint)
        if cur is None or cur.store_id != req.store_id \
                or (zone and cur.zone != zone):
            await self._apply(_cmd(
                _CMD_STORE_UPSERT,
                encode_store_meta(req.store_id, req.endpoint, zone)))
        for blob in req.regions:
            region = Region.decode(blob)
            if self._region_changed(region):
                payload = struct.pack("<H", 0) + region.encode()
                await self._apply(_cmd(_CMD_REGION_UPSERT, payload))
        return StoreHeartbeatResponse()

    async def _region_heartbeat(self, req: RegionHeartbeatRequest
                                ) -> RegionHeartbeatResponse:
        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(RegionHeartbeatResponse)
        self.hb_region_rpcs += 1
        await self._maybe_seed()
        instructions = await self._region_hb_core(
            Region.decode(req.region), req.leader, req.approximate_keys)
        return RegionHeartbeatResponse(
            instructions=[i.encode() for i in instructions])

    async def _store_heartbeat_batch(self, req) -> "object":
        """Delta-batched store reporting: one RPC per store per interval
        with only CHANGED region rows — the PD-plane counterpart of
        group quiescence (idle stores cost one near-empty RPC/s, not
        O(regions)).  Replication stays change-driven exactly as the
        per-region path: an empty batch applies nothing."""
        from tpuraft_torch.rheakv.pd_messages import (
            StoreHeartbeatBatchResponse,
            decode_region_delta,
        )

        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(StoreHeartbeatBatchResponse)
        self.hb_batch_rpcs += 1
        self.hb_delta_rows += len(req.deltas)
        await self._maybe_seed()
        zone = getattr(req, "zone", "")
        self._note_store_health(req.endpoint, getattr(req, "health", ""))
        # fleet observability intake: heat rows ride their own trailing
        # field (independent of deltas — heat changes at its own
        # cadence), occupancy feeds the hibernation fraction
        from tpuraft_torch.util.heat import decode_heat_rows

        heat_rows = decode_heat_rows(getattr(req, "heat", b""))
        self.hb_heat_rows += len(heat_rows)
        for rid, w, r, bi, bo in heat_rows:
            self.stats.record_heat(rid, w, r, bi, bo)
        replicas = getattr(req, "replicas", 0)
        if replicas:
            self._store_occupancy[req.endpoint] = (
                replicas, getattr(req, "replicas_quiescent", 0))
        else:
            self._store_occupancy.pop(req.endpoint, None)
        cur = self.fsm.stores.get(req.endpoint)
        if cur is None or cur.store_id != req.store_id \
                or (zone and cur.zone != zone):
            await self._apply(_cmd(
                _CMD_STORE_UPSERT,
                encode_store_meta(req.store_id, req.endpoint, zone)))
        instructions: list[Instruction] = []
        reported: set[int] = set()
        # zone bookkeeping is invariant across the batch: compute the
        # endpoint->zone map and the leaders-per-zone histogram ONCE
        # instead of per region (O(regions^2) on a 2K-region resync)
        zones = self._store_zones()
        zone_counts = zone_leader_histogram(
            self.fsm.region_leaders, zones) if zones else None
        for blob in req.deltas:
            region_blob, leader, keys = decode_region_delta(blob)
            region = Region.decode(region_blob)
            reported.add(region.id)
            instructions.extend(await self._region_hb_core(
                region, leader, keys, zones, zone_counts))
        # policy pass over the store's UNREPORTED led regions: deltas
        # only flow when something changed, but split re-issue and
        # leader balancing are PD-side decisions that must keep running
        # over the idle majority (the per-region path got this for free
        # by re-reporting every region every interval) — pure in-memory
        # checks, no replication for unchanged rows
        for rid, leader in list(self.fsm.region_leaders.items()):
            if rid in reported:
                continue
            region = self.fsm.regions.get(rid)
            if region is None or \
                    PeerId.parse(leader).endpoint != req.endpoint:
                continue
            instructions.extend(await self._region_hb_core(
                region, leader, self.stats.last_keys(rid),
                zones, zone_counts))
        # lifecycle decisions (ISSUE 20): one merge + one move pick per
        # batch, scoped to regions THIS store leads (instructions ride
        # its heartbeat response).  Decisions replicate before the
        # instruction leaves, so a PD failover re-issues the same pair.
        if self.placement is not None:
            instructions.extend(await self._lifecycle_pass(
                req.endpoint, zones))
        term = node.current_term
        if req.full:
            self._batch_synced[req.endpoint] = term
        # this PD leader's stats (key counts, cooldowns) are term-local:
        # until the store resyncs under THIS term, ask for a full batch
        # so split/balance decisions never run on a cold picture
        need_full = self._batch_synced.get(req.endpoint) != term
        return StoreHeartbeatBatchResponse(
            instructions=[i.encode() for i in instructions],
            need_full=need_full)

    def _store_zones(self) -> dict[str, str]:
        return {ep: rec.zone for ep, rec in self.fsm.stores.items()
                if rec.zone}

    def _note_store_health(self, endpoint: str, health: str) -> None:
        if health:
            self._store_health[endpoint] = health
        else:
            # "" = the store runs no scoring (or predates it): unknown,
            # treated healthy — never leave a stale SICK verdict behind
            self._store_health.pop(endpoint, None)

    async def _region_hb_core(self, region: Region, leader: str,
                              approximate_keys: int,
                              zones: Optional[dict] = None,
                              zone_counts: Optional[dict] = None
                              ) -> list[Instruction]:
        """Shared by the per-region and delta-batched paths: epoch-
        guarded metadata upsert, stats, split/balance instructions.
        ``zones``/``zone_counts`` are precomputed ONCE per batch by the
        batch handler (None = compute here, the single-region path)."""
        node = self.node
        if self._region_changed(region, leader):
            lp = leader.encode()
            payload = struct.pack("<H", len(lp)) + lp + region.encode()
            await self._apply(_cmd(_CMD_REGION_UPSERT, payload))
        self.stats.record(region.id, approximate_keys)
        instructions: list[Instruction] = []
        # NOTE: the PD never finalizes a pending merge from the
        # TARGET's coverage alone.  The target's extended range proves
        # the absorb committed, but NOT that the source's MERGE_COMMIT
        # is durable — if the source leader crashed in that window,
        # tombstoning here would stop the KIND_MERGE re-issue (the only
        # path that proposes MERGE_COMMIT) and leave the sealed source
        # group alive forever, serving stale linearizable GETs for
        # keyspace the target now owns.  Finalization waits for a
        # pd_report_merge from the source group (its leader after
        # commit, every replica at MERGE_COMMIT apply, and any store
        # answering a re-issued instruction for a region it already
        # retired); until one lands, the re-issue arm below keeps
        # driving the source to completion.
        # -- lifecycle: pending-merge re-issue ------------------------------
        pending_merge_tgt = self.fsm.pending_merges.get(region.id)
        if pending_merge_tgt is not None:
            # merging away: re-issue the replicated decision (paced —
            # the store defers mid-conf-change, the absorb can bounce
            # on a stale target leader) and run NO other policy on it
            if self.placement is not None \
                    and self.placement.merge_reissue_due(region.id):
                self.merges_ordered += 1
                instructions.append(Instruction(
                    kind=Instruction.KIND_MERGE, region_id=region.id,
                    new_region_id=pending_merge_tgt,
                    target_peer=self.fsm.region_leaders.get(
                        pending_merge_tgt, "")))
            return instructions
        # an absorb TARGET must not split mid-merge (the extension and
        # the split would race over the same metadata)
        merge_target = region.id in set(self.fsm.pending_merges.values())
        keys_fire = not merge_target and self.stats.should_split(region.id)
        heat_fire = (self.placement is not None and not merge_target
                     and self.placement.should_heat_split(
                         region.id, self.stats)
                     and self.stats.split_pacing_ok(region.id))
        pending_child = self.fsm.pending_splits.get(region.id)
        if pending_child is not None:
            # a split was already ORDERED (possibly by a previous PD
            # leader — the decision is replicated): re-issue the SAME
            # child id while the region still reports oversize (or the
            # heat detector still flags it), paced by the leader-local
            # cooldown.  Never allocate a duplicate.
            if keys_fire or heat_fire:
                self.stats.mark_split_issued(region.id)
                self.splits_ordered += 1
                instructions.append(Instruction(
                    kind=Instruction.KIND_SPLIT, region_id=region.id,
                    new_region_id=pending_child))
        elif keys_fire or heat_fire:
            new_id = await self._apply(_cmd(
                _CMD_SPLIT_ISSUED, struct.pack("<q", region.id)))
            self.stats.mark_split_issued(region.id)
            self.splits_ordered += 1
            if heat_fire and not keys_fire:
                from tpuraft_torch.util.trace import RECORDER

                # heat-DRIVEN split: the detector fired below the
                # key-count threshold — the lifecycle plane's signal
                self.heat_splits_ordered += 1
                if self.placement is not None:
                    self.placement.note_decision(
                        "heat_split", region=region.id, child=new_id)
                RECORDER.record_coalesced("heat_split", str(region.id),
                                          child=new_id)
            instructions.append(Instruction(
                kind=Instruction.KIND_SPLIT, region_id=region.id,
                new_region_id=new_id))
        elif self.opts.balance_leaders or (
                self._store_health.get(_peer_endpoint(leader)) == "sick"):
            # the second arm is the gray-failure DRAIN: even with
            # balancing off, a SICK leader store sheds its leases onto
            # healthy peers (pick_transfer_target skips the >=2
            # imbalance threshold for a sick source and never targets
            # another sick store)
            self.stats.note_leadership(node.current_term,
                                       self.opts.transfer_cooldown_s)
            if zones is None:
                zones = self._store_zones()
            target = self.stats.pick_transfer_target(
                region, leader, self.fsm.region_leaders,
                cooldown_s=self.opts.transfer_cooldown_s,
                zones=zones, zone_counts=zone_counts,
                health=self._store_health)
            if target is not None:
                self.transfers_ordered += 1
                instructions.append(Instruction(
                    kind=Instruction.KIND_TRANSFER_LEADER,
                    region_id=region.id, target_peer=target))
        return instructions

    async def _lifecycle_pass(self, store_ep: str,
                              zones: Optional[dict] = None
                              ) -> list[Instruction]:
        """Batch-scoped lifecycle decisions: at most one cold-merge pick
        and one cross-store move pick per heartbeat batch, both limited
        to regions led from ``store_ep`` (the instruction rides this
        store's response).  A merge decision replicates as a pending
        (source -> target) pair BEFORE the instruction leaves the PD —
        a failover re-issues the same pair; a move needs no replication
        (apply_move is retry-safe and re-picked from live imbalance)."""
        from tpuraft_torch.util.trace import RECORDER

        placement = self.placement
        node = self.node
        placement.note_term(node.current_term,
                            max(placement.opts.merge_cooldown_s,
                                placement.opts.move_cooldown_s))
        out: list[Instruction] = []
        self.stats.maybe_sweep()
        # one merge pick at a time, held until its pending pair is
        # replicated: the floor and in-flight checks count the pending
        # pairs, and a batch that picked during another's replication
        # would not see that one's pair (two picks at the floor plus one
        # merge the fleet under it)
        async with self._merge_pick_lock:
            pick = placement.pick_merge(
                self.fsm.regions, self.fsm.region_leaders, store_ep,
                self.stats, self.fsm.pending_merges, self.fsm.pending_splits)
            if pick is not None:
                src, tgt = pick
                tgt = await self._apply(_cmd(
                    _CMD_MERGE_ISSUED, struct.pack("<qq", src, tgt)))
        if pick is not None:
            self.merges_ordered += 1
            placement.note_decision("merge", region=src, into=tgt)
            RECORDER.record("region_merge_ordered", str(src), into=tgt)
            out.append(Instruction(
                kind=Instruction.KIND_MERGE, region_id=src,
                new_region_id=tgt,
                target_peer=self.fsm.region_leaders.get(tgt, "")))
        mv = placement.pick_move(
            self.fsm.regions, self.fsm.region_leaders, store_ep,
            list(self.fsm.stores.keys()),
            zones if zones is not None else self._store_zones(),
            self._store_health, self.fsm.pending_merges,
            self.fsm.pending_splits)
        if mv is not None:
            rid, src_p, dst_ep = mv
            self.moves_ordered += 1
            placement.note_decision("move", region=rid, src=src_p,
                                    dst=dst_ep)
            RECORDER.record("region_move_ordered", str(rid),
                            src=src_p, dst=dst_ep)
            out.append(Instruction(
                kind=Instruction.KIND_MOVE, region_id=rid,
                target_peer=dst_ep, src_peer=src_p))
        return out

    # -- fleet observability: cluster view + metrics exposition --------------

    def _build_cluster_view(self, top_k: int = 8) -> dict:
        """Fold everything the PD leader knows into one dict: per-store
        roster (zone, health, leader count, occupancy), per-zone access
        rates, top-K hot/cold regions, the sick-store roster and the
        fleet hibernation fraction.  Leader-local like ClusterStats —
        rebuilt from heartbeats after a failover."""
        top_k = max(1, min(top_k or 8, 64))
        self.stats.maybe_sweep()
        leaders_per_ep: dict[str, int] = {}
        for leader in self.fsm.region_leaders.values():
            ep = _peer_endpoint(leader)
            leaders_per_ep[ep] = leaders_per_ep.get(ep, 0) + 1
        stores = []
        for rec in self.fsm.stores.values():
            occ = self._store_occupancy.get(rec.endpoint)
            stores.append({
                "endpoint": rec.endpoint,
                "zone": rec.zone,
                "health": self._store_health.get(rec.endpoint, ""),
                "leaders": leaders_per_ep.get(rec.endpoint, 0),
                "replicas": occ[0] if occ else 0,
                "replicas_quiescent": occ[1] if occ else 0,
            })
        # per-zone rates: each led region's heat lands on its leader's
        # zone ("" = unlabeled stores)
        zones = self._store_zones()
        zone_rates: dict[str, dict] = {}
        for rid, leader in self.fsm.region_leaders.items():
            ent = self.stats.region_stats(rid)
            if ent.writes_s == 0.0 and ent.reads_s == 0.0:
                continue
            z = zones.get(_peer_endpoint(leader), "")
            zr = zone_rates.setdefault(z, {"writes_s": 0.0, "reads_s": 0.0})
            zr["writes_s"] += ent.writes_s
            zr["reads_s"] += ent.reads_s
        zone_rates = {z: {k: round(v, 2) for k, v in zr.items()}
                      for z, zr in zone_rates.items()}

        def _region_row(rid: int, ent) -> dict:
            return {
                "region": rid,
                "leader": self.fsm.region_leaders.get(rid, ""),
                "score": round(ent.score, 2),
                "writes_s": round(ent.writes_s, 2),
                "reads_s": round(ent.reads_s, 2),
                "bytes_in_s": round(ent.bytes_in_s, 1),
                "bytes_out_s": round(ent.bytes_out_s, 1),
                "keys": ent.keys,
            }

        replicas = sum(o[0] for o in self._store_occupancy.values())
        quiescent = sum(o[1] for o in self._store_occupancy.values())
        lifecycle = None
        if self.placement is not None:
            lifecycle = {
                "pending_merges": {str(s): t for s, t
                                   in self.fsm.pending_merges.items()},
                "retired_regions": len(self.fsm.retired_regions),
                "recent": self.placement.recent_decisions(),
                "heat_splits_ordered": self.heat_splits_ordered,
                "merges_ordered": self.merges_ordered,
                "merges_completed": self.merges_completed,
                "moves_ordered": self.moves_ordered,
            }
        return {
            "term": self.node.current_term if self.node else 0,
            "stores": stores,
            "regions": len(self.fsm.regions),
            "zone_rates": zone_rates,
            "hot": [_region_row(rid, ent)
                    for rid, ent in self.stats.top_hot(top_k)],
            "cold": [_region_row(rid, ent)
                     for rid, ent in self.stats.top_cold(top_k)],
            "hot_flagged": sorted(self.stats.hot_regions()),
            "sick_stores": sorted(
                ep for ep, lvl in self._store_health.items()
                if lvl == "sick"),
            "hibernation": {
                "replicas": replicas,
                "quiescent": quiescent,
                "fraction": round(quiescent / replicas, 4)
                if replicas else 0.0,
            },
            # lifecycle plane (None = policy off — legacy PD behavior)
            "lifecycle": lifecycle,
        }

    async def _cluster_describe(self, req) -> "object":
        import json

        from tpuraft_torch.rheakv.pd_messages import ClusterDescribeResponse

        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(ClusterDescribeResponse)
        self.cluster_describes += 1
        view = self._build_cluster_view(getattr(req, "top_k", 8))
        return ClusterDescribeResponse(view_json=json.dumps(view))

    def metrics_text(self) -> str:
        """PD-side Prometheus text: heartbeat/instruction counters plus
        fleet gauges (stores, regions, sick stores, hot regions,
        hibernation).  Served by the ``pd_describe_metrics`` RPC and
        the optional HTTP listener; reads are plain ints/floats
        (best-effort consistency from the exposition thread)."""
        from tpuraft_torch.util.metrics import prometheus_text

        counters = {
            "pd_hb_rpcs": self.hb_rpcs,
            "pd_hb_region_rpcs": self.hb_region_rpcs,
            "pd_hb_batch_rpcs": self.hb_batch_rpcs,
            "pd_hb_delta_rows": self.hb_delta_rows,
            "pd_hb_heat_rows": self.hb_heat_rows,
            "pd_splits_ordered": self.splits_ordered,
            "pd_transfers_ordered": self.transfers_ordered,
            "pd_cluster_describes": self.cluster_describes,
            "pd_hot_region_events": self.stats.hot_events,
            "pd_heat_splits_ordered": self.heat_splits_ordered,
            "pd_merges_ordered": self.merges_ordered,
            "pd_merges_completed": self.merges_completed,
            "pd_moves_ordered": self.moves_ordered,
        }
        # C-atomic list() snapshots: this render runs on the metrics
        # HTTP daemon thread while heartbeats mutate these dicts on the
        # event loop — a bytecode-level genexpr over the live .values()
        # view can raise "dictionary changed size during iteration"
        # (the store side fixed this class with counters_snapshot())
        occ = list(self._store_occupancy.values())
        health = list(self._store_health.values())
        replicas = sum(o[0] for o in occ)
        quiescent = sum(o[1] for o in occ)
        node = self.node
        gauges = {
            "pd_is_leader": int(bool(node and node.is_leader())),
            "pd_stores": len(self.fsm.stores),
            "pd_regions": len(self.fsm.regions),
            "pd_sick_stores": sum(1 for lvl in health if lvl == "sick"),
            "pd_hot_regions": self.stats.hot_count(),
            "pd_pending_merges": len(self.fsm.pending_merges),
            "pd_replicas": replicas,
            "pd_replicas_quiescent": quiescent,
            "pd_hibernation_fraction":
                round(quiescent / replicas, 4) if replicas else 0.0,
        }
        return prometheus_text(counters, gauges,
                               labels={"pd": str(self.server_id)})

    async def _describe_metrics(self, req) -> "object":
        from tpuraft_torch.rpc.cli_messages import DescribeMetricsResponse

        return DescribeMetricsResponse(text=self.metrics_text())

    async def _report_split(self, req: ReportSplitRequest
                            ) -> ReportSplitResponse:
        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(ReportSplitResponse)
        parent = req.parent
        payload = struct.pack("<I", len(parent)) + parent + req.child
        await self._apply(_cmd(_CMD_SPLIT, payload))
        return ReportSplitResponse()

    async def _report_merge(self, req) -> "object":
        """Lifecycle plane: the source store reports a COMPLETED merge
        (seal + absorb + commit all applied) — finalize the replicated
        metadata.  Idempotent: a client retry (or the heartbeat-driven
        finalization racing this report) finds the source already
        popped and applies a no-op."""
        from tpuraft_torch.rheakv.pd_messages import ReportMergeResponse

        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(ReportMergeResponse)
        fresh = await self._apply(_cmd(_CMD_MERGE, struct.pack(
            "<qq", req.source_region_id, req.target_region_id)))
        if fresh:
            self.merges_completed += 1
            self.stats.drop(req.source_region_id)
        return ReportMergeResponse()

    async def _create_region_id(self, req: CreateRegionIdRequest
                                ) -> CreateRegionIdResponse:
        node = self.node
        if node is None or not node.is_leader():
            return self._not_leader(CreateRegionIdResponse)
        rid = await self._apply(_cmd(_CMD_ALLOC_ID))
        return CreateRegionIdResponse(region_id=rid)
