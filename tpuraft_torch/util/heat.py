"""Per-region heat telemetry: decayed-window EWMA access rates.

*Nezha* (PAPERS.md) keys its raft-friendly KV layout decisions off
per-region access telemetry; ROADMAP item 2's heat-driven split/merge/
move needs the same signal.  This module is the intake side: a
:class:`RegionHeatTracker` lives on each store, is fed O(1) from the
serving hot paths (kv_service write admission / read serve) and the FSM
apply loop, and folds the accumulated counts into per-region EWMAs of
writes/s, reads/s and bytes in/out at the PD-heartbeat cadence.

Design choices (docs/architecture.md "Heat is EWMA-decayed server-side"):

- **Accumulate-then-fold**, not per-op EWMA math: the hot path does one
  dict lookup and a few float adds per op (``note_write``/``note_read``
  are on the kv_command_batch item loop); all rate math runs once per
  fold (heartbeat interval), so heat accounting stays inside the
  bench-gate's 3% overhead budget at any op rate.
- **Decay on the server, raw counts never cross the wire**: each fold
  applies ``alpha = 1 - 0.5^(dt / half_life)`` so a silent region's
  rates glide to zero without the PD having to remember per-region
  timestamps for thousands of regions x stores, and a PD failover
  starts from the stores' standing EWMAs (one full heartbeat resync)
  instead of replaying history.
- **Noise-gated reporting**: :func:`heat_changed` mirrors the PR 3
  delta plane's keys gate (~12.5% relative move) so steady heat does
  not defeat delta-batched heartbeats.

Seeded-deterministic: the clock is injectable, fold math is pure, and a
test driving ``note_* + fold`` by hand gets byte-identical rates.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

# one wire row: region_id + 4 float32 rates (writes/s, reads/s,
# bytes_in/s, bytes_out/s) — 24 bytes; rides the delta-batched PD
# heartbeat as a trailing bytes field (pd_messages.encode_heat_rows)
_HEAT_ROW = struct.Struct("<qffff")

# rates below this (ops/s or bytes/s scaled) are "cold enough to forget"
_EPS = 1e-3


# graftcheck: loop-confined — rows live inside RegionHeatTracker's
# rates dict and are folded/served only on the owning store's loop;
# the exposition thread reads plain floats (best-effort, like counters)
@dataclass
class RegionHeat:
    """One region's decayed access rates (all per second)."""

    writes_s: float = 0.0
    reads_s: float = 0.0
    bytes_in_s: float = 0.0
    bytes_out_s: float = 0.0
    # replication-side apply rate (ops applied by the local FSM) —
    # follower load visibility; NOT folded into the serving score and
    # not reported to the PD (leaders' serving rates already cover it)
    applied_s: float = 0.0

    @property
    def score(self) -> float:
        return heat_score(self.writes_s, self.reads_s,
                          self.bytes_in_s, self.bytes_out_s)


def heat_score(writes_s: float, reads_s: float,
               bytes_in_s: float, bytes_out_s: float) -> float:
    """Scalar hot/cold ranking: ops dominate, payload bytes weigh in at
    one op per 4KiB so a few huge-value streams still register.  ONE
    definition shared by the store tracker and the PD's ClusterView /
    hot-region detection — two scores would rank differently."""
    return writes_s + reads_s + (bytes_in_s + bytes_out_s) / 4096.0


def heat_changed(new_score: float, last_score: float,
                 min_abs: float = 0.5) -> bool:
    """Report-worthiness gate (mirrors the delta plane's keys gate): a
    score move under ~12.5% relative AND under ``min_abs`` ops/s is
    noise — steady heat must not re-dirty the heartbeat every round."""
    delta = abs(new_score - last_score)
    if delta < min_abs:
        return False
    return delta * 8.0 >= max(last_score, min_abs)


# graftcheck: loop-confined — note_*/fold/snapshot run on the owning
# store's event loop (kv handlers, FSM caller, the PD heartbeat loop);
# the metrics exposition thread only reads plain floats out of the
# rates dict (best-effort consistency, like every other counter there)
class RegionHeatTracker:
    """Per-store, per-region decayed-window access telemetry.

    Hot path: :meth:`note_write` / :meth:`note_read` /
    :meth:`note_applied` accumulate raw counts O(1).  Cadence path:
    :meth:`fold` (PD heartbeat loop) turns the window's counts into
    rates and decays idle regions; :meth:`heat` / :meth:`top` /
    :meth:`coldest` serve the standing EWMAs.
    """

    def __init__(self, half_life_s: float = 10.0, clock=time.monotonic):
        self.half_life_s = max(half_life_s, 1e-3)
        self._clock = clock
        # region -> [writes, reads, bytes_in, bytes_out, applied] since
        # the last fold (raw counts, not rates)
        self._acc: dict[int, list] = {}
        self._rates: dict[int, RegionHeat] = {}
        self._last_fold = clock()
        # monotonic counters (exposition)
        self.writes_noted = 0
        self.reads_noted = 0
        self.applied_noted = 0
        self.folds = 0

    # -- hot-path intake -----------------------------------------------------

    def _bucket(self, region_id: int) -> list:
        b = self._acc.get(region_id)
        if b is None:
            b = self._acc[region_id] = [0.0, 0.0, 0.0, 0.0, 0.0]
        return b

    def note_write(self, region_id: int, ops: int = 1,
                   bytes_in: int = 0) -> None:
        b = self._bucket(region_id)
        b[0] += ops
        b[2] += bytes_in
        self.writes_noted += ops

    def note_read(self, region_id: int, ops: int = 1,
                  bytes_out: int = 0) -> None:
        b = self._bucket(region_id)
        b[1] += ops
        b[3] += bytes_out
        self.reads_noted += ops

    def note_applied(self, region_id: int, ops: int = 1) -> None:
        b = self._bucket(region_id)
        b[4] += ops
        self.applied_noted += ops

    # -- cadence path --------------------------------------------------------

    def fold(self, now: float | None = None) -> float:
        """Fold the accumulated window into the EWMAs; returns the
        window length in seconds (0.0 = clock didn't advance, nothing
        folded).  Regions whose every rate decayed below noise AND saw
        no traffic this window are forgotten — the maps stay bounded by
        the live working set, not by region-id history."""
        if now is None:
            now = self._clock()
        dt = now - self._last_fold
        if dt <= 0.0:
            return 0.0
        self._last_fold = now
        alpha = 1.0 - 0.5 ** (dt / self.half_life_s)
        acc, self._acc = self._acc, {}
        dead: list[int] = []
        for rid in self._rates.keys() | acc.keys():
            b = acc.get(rid)
            h = self._rates.get(rid)
            if h is None:
                h = self._rates[rid] = RegionHeat()
            w, r, bi, bo, ap = (x / dt for x in b) if b else (0.0,) * 5
            h.writes_s += alpha * (w - h.writes_s)
            h.reads_s += alpha * (r - h.reads_s)
            h.bytes_in_s += alpha * (bi - h.bytes_in_s)
            h.bytes_out_s += alpha * (bo - h.bytes_out_s)
            h.applied_s += alpha * (ap - h.applied_s)
            if b is None and h.score < _EPS and h.applied_s < _EPS:
                dead.append(rid)
        for rid in dead:
            del self._rates[rid]
        self.folds += 1
        return dt

    # -- reads ---------------------------------------------------------------

    def heat(self, region_id: int) -> RegionHeat:
        return self._rates.get(region_id) or RegionHeat()

    def snapshot(self) -> dict[int, RegionHeat]:
        return dict(self._rates)

    def top(self, k: int) -> list[tuple[int, RegionHeat]]:
        """Hottest k tracked regions, descending score."""
        return sorted(self._rates.items(),
                      key=lambda kv: -kv[1].score)[:max(0, k)]

    def coldest(self, k: int) -> list[tuple[int, RegionHeat]]:
        """Coldest k tracked regions, ascending score (only regions the
        tracker still remembers — fully-forgotten regions are colder
        still, but carry no information)."""
        return sorted(self._rates.items(),
                      key=lambda kv: kv[1].score)[:max(0, k)]

    def drop(self, region_id: int) -> None:
        """This region's standing rates no longer describe its keyspace
        — a split just moved half of it (StoreEngine.do_split), or the
        region left the store (merge/move, when that lands): forget
        them and re-accumulate from live traffic."""
        self._acc.pop(region_id, None)
        self._rates.pop(region_id, None)

    # -- observability -------------------------------------------------------

    def counters(self) -> dict:
        return {
            "heat_writes_noted": self.writes_noted,
            "heat_reads_noted": self.reads_noted,
            "heat_applied_noted": self.applied_noted,
            "heat_folds": self.folds,
        }

    def gauges(self) -> dict:
        top = self.top(1)
        return {
            "heat_regions_tracked": len(self._rates),
            "heat_top_score": round(top[0][1].score, 3) if top else 0.0,
        }

    def describe(self) -> str:
        rows = ", ".join(
            f"r{rid}={h.score:.1f}(w{h.writes_s:.1f}/r{h.reads_s:.1f})"
            for rid, h in self.top(4)) or "-"
        return (f"RegionHeatTracker<regions={len(self._rates)} "
                f"writes={self.writes_noted} reads={self.reads_noted} "
                f"applied={self.applied_noted} folds={self.folds} "
                f"top=[{rows}]>")


# -- wire codec (PD heartbeat trailing field) --------------------------------


def encode_heat_rows(rows: list[tuple[int, float, float, float, float]]
                     ) -> bytes:
    """Pack (region_id, writes_s, reads_s, bytes_in_s, bytes_out_s)
    rows for the StoreHeartbeatBatchRequest trailing ``heat`` field;
    an empty list packs to b"" (zero wire cost when nothing moved)."""
    if not rows:
        return b""
    return b"".join(_HEAT_ROW.pack(rid, w, r, bi, bo)
                    for rid, w, r, bi, bo in rows)


def decode_heat_rows(blob: bytes
                     ) -> list[tuple[int, float, float, float, float]]:
    """Tolerant decode: a short/absent blob (old sender) yields no
    rows; a trailing partial row is ignored rather than raising."""
    if not blob:
        return []
    n = len(blob) // _HEAT_ROW.size
    return [_HEAT_ROW.unpack_from(blob, i * _HEAT_ROW.size)
            for i in range(n)]
