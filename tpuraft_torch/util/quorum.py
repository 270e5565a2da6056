"""Quorum-intersection math for membership changes.

Shared by the pytest membership oracle (tests/oracle.py) and the churn
soak's live invariant check (examples/soak.py) so the two can never
silently diverge on what counts as a violation.  Everything here is
verified BY ENUMERATION — exponential in voter-set size, fine for the
≤7-voter sets the chaos drives produce.
"""

from __future__ import annotations

from itertools import combinations
from typing import Iterable


def majorities(s: Iterable) -> list[frozenset]:
    """All minimal majorities (quorums) of voter set ``s``."""
    s = set(s)
    q = len(s) // 2 + 1
    return [frozenset(c) for c in combinations(sorted(s, key=str), q)]


def majorities_intersect(a: Iterable, b: Iterable) -> bool:
    """True iff EVERY majority of voter set ``a`` intersects EVERY
    majority of voter set ``b`` (the safety condition for two quorum
    systems to share decisions).

    Disjoint majorities exist iff each side can fill its quorum while
    ceding the shared members to the other: side a must take
    ``max(0, |Qa| - |a\\b|)`` members from the intersection, likewise b;
    if those demands fit inside ``|a ∩ b|`` together, disjoint quorums
    exist.
    """
    a, b = set(a), set(b)
    if not a or not b:
        return False
    qa, qb = len(a) // 2 + 1, len(b) // 2 + 1
    need_a = max(0, qa - len(a - b))
    need_b = max(0, qb - len(b - a))
    return need_a + need_b > len(a & b)


def witness_minority(voters: Iterable, witnesses: Iterable) -> bool:
    """Config rule for witness voters: witnesses must be a strict
    minority (< quorum) of the voter set, with at least one data voter.
    Guarantees — verified by :func:`every_majority_has_data_peer` —
    that EVERY majority contains at least one payload-holding replica,
    so no quorum can certify a commit that exists on zero data copies.
    """
    voters, witnesses = set(voters), set(witnesses)
    if not witnesses:
        return True
    if not witnesses <= voters or witnesses == voters:
        return False
    return len(witnesses) < len(voters) // 2 + 1


def every_majority_has_data_peer(voters: Iterable,
                                 witnesses: Iterable) -> bool:
    """Enumerate EVERY majority of ``voters`` and check each contains
    at least one non-witness (data) member — the witness-safety quorum
    condition (a majority made of witnesses alone could ack a commit
    held on zero data replicas)."""
    witnesses = set(witnesses)
    return all(m - witnesses for m in majorities(voters))


def witness_only_majorities(voters: Iterable,
                            witnesses: Iterable) -> list[frozenset]:
    """Majorities containing NO data replica — each is a quorum that
    must never certify a commit.  Two independent mechanisms enforce
    that: config validation (witness_minority makes this list empty for
    valid confs) and, defense in depth, witnesses never campaign — a
    commit quorum always contains the (data) leader, and the ballot box
    additionally clamps the commit point to the data replicas' best
    match (ballot_box.commit_point)."""
    witnesses = set(witnesses)
    return [m for m in majorities(voters) if not (m - witnesses)]


def joint_quorums_intersect(old: Iterable, new: Iterable) -> bool:
    """A joint (C_old,new) decision takes a majority of BOTH sets.
    Verify by enumeration that every such dual quorum intersects every
    majority of old, every majority of new, and every other dual quorum
    — the quorum-intersection invariant across a membership change."""
    old, new = set(old), set(new)
    if not old or not new:
        return False
    duals = [qo | qn for qo in majorities(old) for qn in majorities(new)]
    singles = majorities(old) + majorities(new)
    return (all(d & m for d in duals for m in singles)
            and all(d1 & d2 for d1 in duals for d2 in duals))
