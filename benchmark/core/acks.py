"""The commit plane's acks, drawn from a seed: a ring of ``ring_ticks``
pre-drawn ticks, each a [G, P] plane of the entries every peer slot
acknowledges that tick; tick i streams ring[i % ring_ticks].

Slot 0 is the leader: it acknowledges its own appends in the tick they
land.  Each of the other ``voters - 1`` slots is a follower whose match
trails the leader's by 0 to ``max_lag_ticks`` ticks, drawn afresh each
tick (and never falling), so a group's commit is set by its faster
follower; every follower has caught up at the ring's last tick, so the
ring repeats.  Slots past ``voters`` ack nothing.  The leader's appends,
by the traffic file's ``kind``:

- ``uniform``: every group appends ``min_entries`` to ``max_entries``
  entries every tick, uniformly;
- ``zipf``: ``appends_per_tick`` appends land on groups drawn Zipf
  (``theta``) over the G groups (rank r with weight 1 / r**theta, the
  ranks placed on groups by a seeded permutation, as YCSB's scrambled
  zipfian places them on keys).
"""

from __future__ import annotations

import numpy as np

DTYPE = np.int16


def zipf_cdf(n: int, theta: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), theta)
    c = np.cumsum(w)
    return c / c[-1]


def leader_appends(traffic: dict, groups: int, ring_ticks: int,
                   rng: np.random.Generator) -> np.ndarray:
    """[ring_ticks, G] int64: the entries each group's leader appends."""
    kind = traffic["kind"]
    if kind == "uniform":
        lo, hi = int(traffic["min_entries"]), int(traffic["max_entries"])
        if not 0 <= lo <= hi:
            raise ValueError(f"uniform appends {lo}..{hi}")
        return rng.integers(lo, hi + 1, (ring_ticks, groups))
    if kind == "zipf":
        n = int(traffic["appends_per_tick"])
        cdf = zipf_cdf(groups, float(traffic["theta"]))
        perm = rng.permutation(groups)
        out = np.zeros((ring_ticks, groups), np.int64)
        for t in range(ring_ticks):
            ranks = np.minimum(np.searchsorted(cdf, rng.random(n)),
                               groups - 1)
            out[t] = np.bincount(perm[ranks], minlength=groups)
        return out
    raise ValueError(f"ack kind {kind!r}")


def follower_acks(lead_match: np.ndarray, max_lag: int,
                  rng: np.random.Generator) -> np.ndarray:
    """[ring_ticks, G] int64: a follower's acks a tick, its match the
    leader's ``lag`` ticks before (``lag`` drawn each tick in
    0..max_lag), never falling, and caught up at the last tick."""
    r, g = lead_match.shape
    lag = rng.integers(0, max_lag + 1, (r, g))
    lag[-1] = 0
    src = np.arange(r)[:, None] - lag
    seen = np.where(src >= 0, np.take_along_axis(
        lead_match, np.maximum(src, 0), axis=0), 0)
    match = np.maximum.accumulate(seen, axis=0)
    return np.diff(match, axis=0, prepend=0)


def make_ring(traffic: dict, groups: int, peers: int, voters: int,
              ring_ticks: int, seed: int) -> np.ndarray:
    """The ring, [ring_ticks, G, P] of ``DTYPE``."""
    if not 1 <= voters <= peers:
        raise ValueError(f"{voters} voters in {peers} slots")
    rng = np.random.default_rng(seed)
    lead = leader_appends(traffic, groups, ring_ticks, rng)
    lead_match = np.cumsum(lead, axis=0)
    max_lag = int(traffic.get("max_lag_ticks", 0))
    ring = np.zeros((ring_ticks, groups, peers), DTYPE)
    cols = [lead] + [follower_acks(lead_match, max_lag, rng)
                     for _ in range(voters - 1)]
    for s, col in enumerate(cols):
        if col.max() > np.iinfo(DTYPE).max:
            raise ValueError("a slot's acks in one tick overflow "
                             f"{np.dtype(DTYPE).name}")
        ring[:, :, s] = col
    return ring


class RingView:
    """``view[i]`` is tick i's acks: ring[i % len(ring)]."""

    def __init__(self, ring: np.ndarray):
        self.ring = ring

    def __getitem__(self, i: int) -> np.ndarray:
        return self.ring[i % self.ring.shape[0]]
