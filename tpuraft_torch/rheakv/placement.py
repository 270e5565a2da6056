"""Region lifecycle placement engine: heat-driven split / cold merge /
cross-store move decisions for the PD leader.

Reference parity: the scheduling half of ``pd:ClusterStatsManager`` +
TiKV-PD-style operators, grown over this repo's heat plane (ISSUE 20).
The engine turns the PD leader's live picture — per-region
:class:`~tpuraft.rheakv.pd_server.RegionStats` (key counts + heat
EWMAs), the hot-region detector, store zone labels and gray-failure
health — into three actuators:

- **split** a HOT region even below the key-count threshold (the heat
  detector, not key counts, is the signal; a small floor keeps
  single-key hotspots from splitting into empty shells),
- **merge** an adjacent COLD pair (the colder region is the SOURCE and
  is absorbed into its neighbor; the decision is replicated as a
  pending merge so a PD failover re-issues the SAME pair),
- **move** a replica off a crowded store onto a roomy, healthy one
  (add-learner → catch up → promote + remove on joint consensus,
  executed store-side; SICK stores are never destinations).

Like ``ClusterStatsManager``, every pacing clock here is PD-leader-
local and ephemeral: after a failover the new leader re-derives its
picture from heartbeats, and ``note_term`` rebuilds the cooldowns so
the fresh leader cannot double-order what its predecessor just did.
The DECISIONS that must survive failover (pending merges, allocated
split ids) are replicated through the PD group by the caller.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from tpuraft_torch.rheakv.metadata import Region


def _peer_endpoint(peer_str: str) -> str:
    return ":".join(peer_str.split("/", 1)[0].split(":")[:2])


def _is_voter(peer_str: str) -> bool:
    return not (peer_str.endswith("/learner")
                or peer_str.endswith("/witness"))


@dataclass
class LifecycleOptions:
    """Policy knobs (surfaced via PlacementDriverOptions.lifecycle_*)."""

    # heat-driven split: a hot-flagged region splits regardless of the
    # key-count threshold, provided it holds at least this many keys
    # (a one-key hotspot has nothing to split)
    heat_split_min_keys: int = 32
    # cold merge: the SOURCE must score at most this and hold at most
    # merge_max_keys keys (big cold regions would churn big absorb
    # blobs through the target group's log)
    merge_max_score: float = 0.05
    merge_max_keys: int = 4096
    # the surviving TARGET may be warmer than the source, but not hot:
    # its score must stay under this multiple of merge_max_score
    merge_target_factor: float = 8.0
    # pacing + caps
    merge_cooldown_s: float = 10.0
    max_inflight_merges: int = 2
    # never merge the fleet below this many regions
    min_regions: int = 4
    # cross-store move: the source store must host at least this many
    # more replicas than the destination
    move_imbalance: int = 2
    move_cooldown_s: float = 10.0
    max_inflight_moves: int = 2


class PlacementEngine:
    """Leader-local lifecycle policy over the PD's cluster picture.

    One instance per :class:`PlacementDriverServer`; every method runs
    on the PD node's RPC loop (heartbeat handlers), so the state needs
    no locks.  The engine DECIDES; replication and instruction delivery
    stay with the PD server.
    """

    # bounded memory of recent decisions for the admin plane
    # (examples/admin.py regions --pd) and the ClusterView
    RECENT_MAX = 64

    def __init__(self, opts: LifecycleOptions) -> None:
        self.opts = opts
        self._term = -1
        self._grace_until = 0.0
        # region -> deadline: a region recently ORDERED merged/moved is
        # left alone (attempt-paced, like the evacuation cooldowns)
        self._merge_cooldown: dict[int, float] = {}
        self._move_cooldown: dict[int, float] = {}
        # region -> (src_peer, dst_peer, deadline): moves ordered but
        # not yet observed in the region's reported peers — counted as
        # already-moved so one heartbeat burst can't order the whole
        # imbalance at once
        self._inflight_moves: dict[int, tuple[str, str, float]] = {}
        self.recent: deque = deque(maxlen=self.RECENT_MAX)

    def note_term(self, term: int, cooldown_s: float) -> None:
        """PD leadership changed: pacing state is leader-local, so the
        new leader starts every region on one full cooldown (the
        note_leadership idiom — an immediate re-order of something the
        predecessor just ordered becomes structurally impossible)."""
        if term == self._term:
            return
        self._term = term
        # graftcheck: allow(raw-clock) — PD-side post-failover grace (real time)
        self._grace_until = time.monotonic() + cooldown_s
        self._merge_cooldown.clear()
        self._move_cooldown.clear()
        self._inflight_moves.clear()

    def note_decision(self, kind: str, **fields) -> None:
        self.recent.append({"kind": kind, "term": self._term, **fields})

    def recent_decisions(self) -> list[dict]:
        return list(self.recent)

    # -- heat-driven split ---------------------------------------------------

    def should_heat_split(self, region_id: int, stats) -> bool:
        """True when the heat detector flags the region and it holds
        enough keys to be worth splitting.  The caller still routes
        through the replicated pending-split allocation, so a PD
        failover re-issues the SAME child id."""
        if region_id not in stats.hot_regions():
            return False
        return stats.last_keys(region_id) >= self.opts.heat_split_min_keys

    # -- cold merge ----------------------------------------------------------

    def pick_merge(self, regions: dict[int, Region],
                   region_leaders: dict[int, str], leader_ep: str,
                   stats, pending_merges: dict[int, int],
                   pending_splits: dict[int, int]
                   ) -> Optional[tuple[int, int]]:
        """Pick one (source, target) cold-adjacent pair whose SOURCE is
        led from ``leader_ep`` (instructions ride that store's
        heartbeat response, so only its led regions can act).  The
        colder region of the pair is the source; the survivor extends
        over it."""
        # graftcheck: allow(raw-clock) — PD-side merge pacing (real time)
        now = time.monotonic()
        if now < self._grace_until:
            return None
        if len(pending_merges) >= max(1, self.opts.max_inflight_merges):
            return None
        live = len(regions) - len(pending_merges)
        if live <= max(2, self.opts.min_regions):
            return None
        self._merge_cooldown = {r: d for r, d in
                                self._merge_cooldown.items() if d > now}
        # regions already involved in a merge (either side) or a split
        # are off the table — one multi-step protocol per region
        busy = (set(pending_merges) | set(pending_merges.values())
                | set(pending_splits) | set(pending_splits.values()))
        hot = stats.hot_regions()
        # adjacency index over the CURRENT tiling
        by_start = {r.start_key: r for r in regions.values()}

        def cold(rid: int, factor: float = 1.0) -> bool:
            ent = stats.region_stats(rid)
            return (ent.score <= self.opts.merge_max_score * factor
                    and rid not in hot)

        best: Optional[tuple[float, int, int]] = None
        for rid, region in regions.items():
            if rid in busy or rid in self._merge_cooldown:
                continue
            leader = region_leaders.get(rid, "")
            if not leader or _peer_endpoint(leader) != leader_ep:
                continue
            ent = stats.region_stats(rid)
            if not cold(rid) or ent.keys > self.opts.merge_max_keys:
                continue
            # the RIGHT neighbor (its start is our end) absorbs us;
            # merging left would need the neighbor's leader to act
            if region.end_key == b"":
                continue  # rightmost region has no right neighbor
            neigh = by_start.get(region.end_key)
            if neigh is None or neigh.id in busy \
                    or neigh.id in self._merge_cooldown:
                continue
            if not cold(neigh.id, self.opts.merge_target_factor):
                continue
            if not region_leaders.get(neigh.id):
                continue  # leaderless target can't absorb
            key = (ent.score, ent.keys, rid)
            if best is None or key < best:
                best = key
                pair = (rid, neigh.id)
        if best is None:
            return None
        src, tgt = pair
        self._merge_cooldown[src] = now + self.opts.merge_cooldown_s
        self._merge_cooldown[tgt] = now + self.opts.merge_cooldown_s
        return src, tgt

    def merge_reissue_due(self, source_id: int) -> bool:
        """Pace re-issue of an already-replicated pending merge (the
        source store defers mid-conf-change, bounces on a stale target
        leader, ...): at most one instruction per cooldown window."""
        # graftcheck: allow(raw-clock) — PD-side merge pacing (real time)
        now = time.monotonic()
        if self._merge_cooldown.get(source_id, 0.0) > now:
            return False
        self._merge_cooldown[source_id] = now + self.opts.merge_cooldown_s
        return True

    # -- cross-store move ----------------------------------------------------

    def pick_move(self, regions: dict[int, Region],
                  region_leaders: dict[int, str], leader_ep: str,
                  store_eps: list[str], zones: dict[str, str],
                  health: dict[str, str],
                  pending_merges: dict[int, int],
                  pending_splits: dict[int, int]
                  ) -> Optional[tuple[int, str, str]]:
        """Pick one (region_id, src_peer, dst_peer) replica move for a
        region led from ``leader_ep``: shed a replica from the most
        crowded store onto the roomiest healthy store that doesn't
        already host one — preferring a destination whose ZONE the
        region doesn't cover yet.  Never targets SICK stores."""
        # graftcheck: allow(raw-clock) — PD-side move pacing (real time)
        now = time.monotonic()
        if now < self._grace_until:
            return None
        self._move_cooldown = {r: d for r, d in
                               self._move_cooldown.items() if d > now}
        self._inflight_moves = {
            r: m for r, m in self._inflight_moves.items() if m[2] > now
            and (r in regions
                 and any(_peer_endpoint(p) == _peer_endpoint(m[0])
                         for p in regions[r].peers))}
        if len(self._inflight_moves) >= max(1, self.opts.max_inflight_moves):
            return None
        busy = (set(pending_merges) | set(pending_merges.values())
                | set(pending_splits) | set(pending_splits.values()))
        # replica count per store endpoint, with in-flight moves
        # overlaid (source already "lost" the replica, dest "gained" it)
        counts: dict[str, int] = {ep: 0 for ep in store_eps}
        for region in regions.values():
            for p in region.peers:
                ep = _peer_endpoint(p)
                if ep in counts:
                    counts[ep] += 1
        for _rid, (src_p, dst_p, _d) in self._inflight_moves.items():
            s, d = _peer_endpoint(src_p), _peer_endpoint(dst_p)
            if s in counts:
                counts[s] -= 1
            if d in counts:
                counts[d] += 1

        def sick(ep: str) -> bool:
            return health.get(ep, "") == "sick"

        best: Optional[tuple[tuple, int, str, str]] = None
        for rid, region in regions.items():
            if rid in busy or rid in self._move_cooldown \
                    or rid in self._inflight_moves:
                continue
            leader = region_leaders.get(rid, "")
            if not leader or _peer_endpoint(leader) != leader_ep:
                continue
            hosted = {_peer_endpoint(p) for p in region.peers}
            hosted_zones = {zones.get(ep, "") for ep in hosted}
            # movable replicas: plain voters only (witness journals and
            # learner roles don't survive a generic move), and prefer
            # NOT the leader itself (the store would have to hand
            # leadership off first and defer)
            movable = [p for p in region.peers if _is_voter(p)]
            if len(movable) < 2:
                continue
            for src_p in movable:
                src_ep = _peer_endpoint(src_p)
                for dst_ep in store_eps:
                    if dst_ep in hosted or sick(dst_ep):
                        continue
                    gap = counts.get(src_ep, 0) - counts.get(dst_ep, 0)
                    if gap < max(1, self.opts.move_imbalance):
                        continue
                    new_zone = int(zones.get(dst_ep, "")
                                   not in hosted_zones)
                    is_leader_src = int(src_ep == _peer_endpoint(leader))
                    # widest gap first, then zone diversity, then
                    # non-leader sources, then a stable hash spread
                    key = (-gap, -new_zone, is_leader_src,
                           hash((rid, src_ep, dst_ep)) & 0xffff)
                    if best is None or key < best[0]:
                        best = (key, rid, src_p, dst_ep)
        if best is None:
            return None
        _, rid, src_p, dst_ep = best
        self._move_cooldown[rid] = now + self.opts.move_cooldown_s
        self._inflight_moves[rid] = (
            src_p, dst_ep, now + 3 * self.opts.move_cooldown_s)
        return rid, src_p, dst_ep
