"""The plain reference of the commit-plane cells, in numpy.

It recomputes a tick's commit row from the acks the harness drew: the
host's match after tick t is the sum of the acks of ticks 0..t, and a
leader's commit is the majority-th largest match among its voters
(BallotBox#commitAt), counted only from the group's first entry of the
current leadership (``pending_rel``), and never below the commit before
it.  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"bad_rows": 0, "rows_missing": 0}  # exact: limit 0


def quorum_match(match: np.ndarray, voter_mask: np.ndarray) -> np.ndarray:
    """The majority-th largest voter match of each row: [G] int64 (0
    where a row has no voter)."""
    n_v = voter_mask.sum(axis=1)
    q = n_v // 2 + 1
    m = np.where(voter_mask, match.astype(np.int64), np.iinfo(np.int64).min)
    m = np.sort(m, axis=1)[:, ::-1]  # largest first
    rows = np.arange(match.shape[0])
    out = m[rows, np.clip(q - 1, 0, match.shape[1] - 1)]
    return np.where(n_v > 0, out, 0)


def commit_row(match, voter_mask, prev_commit, pending_rel, leader):
    quorum = quorum_match(match, voter_mask)
    can = leader & (quorum >= pending_rel)
    return np.where(can, np.maximum(prev_commit, quorum), prev_commit)


class Acks:
    """The cumulative match of any tick from the ring of acks."""

    def __init__(self, ring: np.ndarray):
        self.r = ring.shape[0]
        self.prefix = np.zeros((self.r + 1,) + ring.shape[1:], np.int64)
        np.cumsum(ring, axis=0, dtype=np.int64, out=self.prefix[1:])

    def match_after(self, tick: int) -> np.ndarray:
        """The match once tick ``tick``'s acks have landed."""
        n = tick + 1
        return (n // self.r) * self.prefix[self.r] + self.prefix[n % self.r]


def check(rows: dict[int, np.ndarray], ring: np.ndarray,
          voters: int) -> dict:
    """Compare the program's commit rows of the given ticks with the
    reference's: ``bad_rows`` counts the rows that differ anywhere."""
    acks = Acks(ring)
    g, p = ring.shape[1:]
    voter_mask = np.zeros((g, p), bool)
    voter_mask[:, :voters] = True
    leader = np.ones(g, bool)
    pending = np.ones(g, np.int64)
    prev = np.zeros(g, np.int64)
    bad = 0
    for t in sorted(rows):
        want = commit_row(acks.match_after(t), voter_mask, prev, pending,
                          leader)
        if not np.array_equal(np.asarray(rows[t], np.int64), want):
            bad += 1
        prev = want
    return {"bad_rows": bad, "rows_compared": len(rows)}
