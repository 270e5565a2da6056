"""Peaks of the card and the bytes a kernel has to move.

A roofline share is the least time the card could take (the bytes the
call must move at the peak memory rate) over the time it took.  Bytes
are counted from the shapes: each input read once and each output
written once, whatever the kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (80 GB HBM3); rates assume the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"

# the fused tick's operands by the dtypes of the port's GroupState,
# TickParams and TickOutputs (tpuraft_torch/ops/tick.py): name -> (bytes
# an element, rank: 1 = [G], 2 = [G, P])
STATE_FIELDS = {
    "role": (4, 1), "commit_rel": (4, 1), "pending_rel": (4, 1),
    "match_rel": (4, 2), "granted": (1, 2), "voter_mask": (1, 2),
    "old_voter_mask": (1, 2), "elect_deadline": (4, 1),
    "hb_deadline": (4, 1), "last_ack": (4, 2), "snap_deadline": (4, 1),
    "quiescent": (1, 1), "witness_mask": (1, 2),
    "stepdown_deadline": (4, 1), "fence_start": (4, 1),
}
PARAM_FIELDS = ("election_timeout_ms", "heartbeat_ms", "lease_ms",
                "snapshot_ms")  # int32, a scalar or a [G] row each
OUTPUT_FIELDS = {
    "commit_rel": 4, "q_ack": 4, "commit_advanced": 1, "elected": 1,
    "election_due": 1, "step_down": 1, "hb_due": 1, "lease_valid": 1,
    "snap_due": 1, "stepdown_due": 1, "fence_ok": 1,
}  # [G] each
DEADLINE_ROWS = 3  # raft_tick also writes the hb, snapshot, stepdown rows


def fused_tick_bytes(g: int, p: int, param_rows: bool = False,
                     deadlines: bool = True) -> int:
    """Bytes one fused tick of G groups x P slots must move: every
    state field and parameter read once, the packed outputs written
    once and, for ``raft_tick`` (``deadlines``), the three advanced
    deadline rows."""
    n = sum(size * (g * p if rank == 2 else g)
            for size, rank in STATE_FIELDS.values())
    n += len(PARAM_FIELDS) * 4 * (g if param_rows else 1)
    n += sum(OUTPUT_FIELDS.values()) * g
    if deadlines:
        n += DEADLINE_ROWS * 4 * g
    return n


def least_seconds(nbytes: int, card: str = DEFAULT_CARD) -> float:
    return nbytes / PEAKS.get(card, PEAKS[DEFAULT_CARD])["hbm_bytes_per_s"]
