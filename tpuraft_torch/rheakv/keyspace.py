"""Keyspace tiling invariants: the region lifecycle oracle.

The multi-raft KV's load-bearing metadata invariant is that the region
set TILES the keyspace: sorted by start key, the regions cover
[b"", +inf) with no gaps and no overlaps (b"" is the -inf/+inf sentinel
on both bounds).  Splits preserve it by construction (parent shrinks,
child takes the tail) and merges must too (the target extends exactly
over the absorbed source) — a lifecycle bug shows up here first, as a
hole (lost keyspace: keys nobody serves) or an overlap (double
ownership: two groups both accept writes for one key).

Lives under ``tpuraft/`` rather than ``tests/`` so the chaos soak's
LIVE invariant check (examples/soak.py, which can't import tests/)
shares ONE implementation with the tests/oracle.py re-export — the same
arrangement as util/quorum.py and the membership oracle.
"""

from __future__ import annotations

from typing import Iterable


def coverage_errors(regions: Iterable) -> list[str]:
    """Check a region set tiles the keyspace; returns human-readable
    violations ([] = invariant holds).  Accepts any iterable of objects
    with ``id``/``start_key``/``end_key`` (Region or a stand-in)."""
    rows = sorted(regions, key=lambda r: r.start_key)
    errors: list[str] = []
    if not rows:
        return ["no regions: keyspace entirely uncovered"]
    seen: dict[int, object] = {}
    for r in rows:
        if r.id in seen:
            errors.append(f"region id {r.id} appears twice")
        seen[r.id] = r
    if rows[0].start_key != b"":
        errors.append(
            f"keyspace hole before region {rows[0].id}: "
            f"[b'', {rows[0].start_key!r}) is uncovered")
    for prev, cur in zip(rows, rows[1:]):
        if prev.end_key == b"":
            # an unbounded end anywhere but the last slot overlaps
            # everything after it
            errors.append(
                f"region {prev.id} is unbounded but region {cur.id} "
                f"starts at {cur.start_key!r} inside it")
        elif prev.end_key < cur.start_key:
            errors.append(
                f"keyspace hole [{prev.end_key!r}, {cur.start_key!r}) "
                f"between regions {prev.id} and {cur.id}")
        elif prev.end_key > cur.start_key:
            errors.append(
                f"regions {prev.id} and {cur.id} overlap on "
                f"[{cur.start_key!r}, {prev.end_key!r})")
    if rows[-1].end_key != b"":
        errors.append(
            f"keyspace hole after region {rows[-1].id}: "
            f"[{rows[-1].end_key!r}, +inf) is uncovered")
    return errors


def assert_covers(regions: Iterable, context: str = "") -> None:
    """Raise AssertionError with every violation when the region set
    does not tile the keyspace."""
    errors = coverage_errors(regions)
    assert not errors, (
        (f"{context}: " if context else "") + "; ".join(errors))
