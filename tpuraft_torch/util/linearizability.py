"""Linearizability checking for concurrent KV histories.

The reference validates distributed correctness with latch-style chaos
asserts (`test:core/NodeTest` kill/restart + convergence checks,
RheaKV chaos tests — SURVEY.md §5).  This module goes further: record
the real-time invoke/return windows of concurrent client operations and
*prove* the observed results admit a legal sequential order — the
linearizability promise raft-backed stores actually make (Herlihy &
Wing; checker in the style of Wing & Gong's DFS with Lowe's
state-memoization, as used by Knossos/porcupine).

Usage::

    h = History()
    tok = h.invoke(client_id, "w", (b"k", b"v1"))   # before the call
    h.complete(tok, True)                            # with the result
    ...
    report = check_history(h)        # partitions per key (linearizability
    assert report.ok                 # is compositional), checks each

Operations that never returned (client crashed / timed out / ambiguous
error) stay *pending*: the checker may linearize them at any point after
their invoke — or never (the op may not have taken effect).  This is
exactly the "info" semantics chaos histories need: a put whose ack was
lost to a leader kill is allowed, but not required, to be visible.

Scaling envelope: the search is worst-case exponential (linearizability
checking is NP-complete — Gibbons & Korach); memoization plus the
pending-op prunings below keep realistic histories tractable up to a
few thousand ops per key with up to a few hundred surviving pending
ops.  Pace recorders accordingly (a few ms between ops) — beyond that,
`max_states` raises instead of hanging.

Checked op kinds over a single key (a register):

==========  ======================  =======================================
kind        args                    result semantics
==========  ======================  =======================================
``w``       ``(key, value)``        write; result ignored (``True`` ack)
``r``       ``(key,)``              must return the current value (None if
                                    absent)
``cas``     ``(key, expect, upd)``  ``True`` iff state == expect (then
                                    state := upd)
``pia``     ``(key, value)``        put-if-absent: returns prior value;
                                    writes only if state is None
``del``     ``(key,)``              delete; result ignored
==========  ======================  =======================================
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Op:
    op_id: int
    client: int
    kind: str
    args: tuple
    invoke: float
    ret: Optional[float] = None      # None = pending (maybe applied)
    result: object = None

    @property
    def key(self) -> bytes:
        return self.args[0]

    def __str__(self) -> str:
        win = f"[{self.invoke:.6f}, " + (
            f"{self.ret:.6f}]" if self.ret is not None else "...)")
        return (f"op{self.op_id} c{self.client} {self.kind}"
                f"{self.args[1:] if len(self.args) > 1 else ''}"
                f" -> {self.result!r} {win}")


class History:
    """Thread-safe-enough recorder for one asyncio process: `invoke`
    before issuing the client call, `complete` with the observed result.
    An op never completed is pending — the checker treats it as
    maybe-applied."""

    def __init__(self) -> None:
        self._ops: list[Op] = []

    def invoke(self, client: int, kind: str, args: tuple,
               now: Optional[float] = None) -> int:
        op = Op(len(self._ops), client, kind, tuple(args),
                time.monotonic() if now is None else now)
        self._ops.append(op)
        return op.op_id

    def complete(self, op_id: int, result: object,
                 now: Optional[float] = None) -> None:
        op = self._ops[op_id]
        op.ret = time.monotonic() if now is None else now
        op.result = result

    def discard(self, op_id: int) -> None:
        """Forget an op known to have NOT executed (e.g. rejected
        client-side before any RPC left the process)."""
        self._ops[op_id].kind = "_discarded"

    def ops(self) -> list[Op]:
        return [o for o in self._ops if o.kind != "_discarded"]


# ---------------------------------------------------------------------------
# single-register model
# ---------------------------------------------------------------------------

def _apply(kind: str, args: tuple, result: object, completed: bool,
           state):
    """Try to linearize one op against register value ``state``.

    Returns the new state, or raises _Illegal if the op's *observed*
    result contradicts the model.  Pending ops (completed=False) have no
    observed result: any model outcome is acceptable."""
    if kind == "w":
        return args[1]
    if kind == "del":
        return None
    if kind == "r":
        if completed and state != result:
            raise _Illegal
        return state
    if kind == "cas":
        ok = state == args[1]
        if completed and bool(result) != ok:
            raise _Illegal
        return args[2] if ok else state
    if kind == "pia":
        if state is None:
            if completed and result is not None:
                raise _Illegal
            return args[1]
        if completed and result != state:
            raise _Illegal
        return state
    raise ValueError(f"unknown op kind {kind!r}")


class _Illegal(Exception):
    pass


def _prunable_pending(op: Op, key_ops: list[Op]) -> bool:
    """True if dropping this *pending* op cannot change the verdict.

    A pending read observes nothing and changes nothing: any witness
    containing it maps to one without it.  In a history whose ops are
    only writes/reads/deletes, a pending write of a value no completed
    read ever returned can likewise never be *required*: completed
    reads between it and the next state change would have had to return
    its value, so in every witness the interval it governs contains no
    completed observation — removing it leaves every completed op's
    legality unchanged.  (With CAS/put-if-absent in the history this
    does not hold — a failed CAS can observe "state != expect" — so no
    write pruning happens then.)  Pruning matters: chaos histories pile
    up maybe-applied ops, and each un-prunable pending op doubles the
    reachable linearization frontier.
    """
    if op.ret is not None:
        return False
    if op.kind == "r":
        return True
    if op.kind != "w":
        return False
    if any(o.kind not in ("w", "r", "del") for o in key_ops):
        return False
    v = op.args[1]
    return not any(o.ret is not None and o.kind == "r" and o.result == v
                   for o in key_ops)


# ---------------------------------------------------------------------------
# checker
# ---------------------------------------------------------------------------

@dataclass
class KeyReport:
    key: bytes
    ok: bool
    n_ops: int
    n_pending: int
    witness: list[int] = field(default_factory=list)   # op ids in order
    # on failure: the op set the search could never extend past
    stuck_ops: list[str] = field(default_factory=list)


@dataclass
class Report:
    ok: bool
    keys: dict[bytes, KeyReport]

    def __str__(self) -> str:
        bad = [k for k, r in self.keys.items() if not r.ok]
        if self.ok:
            total = sum(r.n_ops for r in self.keys.values())
            return (f"linearizable: {len(self.keys)} keys, {total} ops "
                    f"({sum(r.n_pending for r in self.keys.values())} pending)")
        lines = [f"NOT linearizable: keys {bad}"]
        for k in bad:
            r = self.keys[k]
            lines += [f"  key {k!r}:"] + [f"    {s}" for s in r.stuck_ops]
        return "\n".join(lines)


def check_register(ops: list[Op], initial=None,
                   max_states: int = 2_000_000) -> KeyReport:
    """Check one key's ops for linearizability against a register model.

    Iterative DFS over (linearized-set, register-state) with
    memoization.  All completed ops must be linearized; pending ops may
    be linearized (never before their invoke) or simply left unplaced —
    an op that never took effect.  Real-time order: op A must precede
    op B iff A.ret < B.invoke.  (Strict: exact timestamp ties are
    treated as concurrency.  Tie-as-precedence is NOT an order — two
    zero-duration ops at one instant would mutually precede each other
    and deadlock the search, failing valid histories; and monotonic-ns
    clocks make ties between genuinely ordered calls effectively
    impossible, so nothing real is lost.)
    """
    key = ops[0].key if ops else b""
    ops = [o for o in ops if not _prunable_pending(o, ops)]
    ops = sorted(ops, key=lambda o: o.invoke)
    n = len(ops)
    completed = [o.ret is not None for o in ops]
    completed_mask = sum(1 << i for i in range(n) if completed[i])
    n_pending = n - sum(completed)
    if n == 0:
        return KeyReport(key, True, 0, 0)
    rets = [o.ret if o.ret is not None else float("inf") for o in ops]

    def _candidates(done_mask: int):
        """Ops placeable next: not yet placed, and invoked no later than
        every unplaced completed op's return (an op whose return
        strictly precedes another's invoke must be linearized first).

        Ties (A.ret == B.invoke) are CONCURRENCY, not precedence: the
        strict `A.ret < B.invoke` order is what keeps precedence an
        interval order — treating ties as precedence makes two
        zero-duration ops at the same instant mutually precede each
        other (a cycle: neither is ever placeable) and falsely fails
        linearizable histories.  Hence `<=` below, matching the
        docstring's A.ret < B.invoke definition exactly."""
        min_ret = float("inf")
        for i in range(n):
            if not done_mask >> i & 1 and completed[i] and rets[i] < min_ret:
                min_ret = rets[i]
        out = []
        for i in range(n):
            if done_mask >> i & 1:
                continue
            if ops[i].invoke <= min_ret:
                out.append(i)
            else:
                break  # sorted by invoke; later ops can only be later
        return out

    seen: set = set()
    stack = [(0, initial)]                  # (done_mask, register value)
    parent: dict[tuple, tuple] = {}
    best_mask = 0

    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        if len(seen) > max_states:
            raise RuntimeError(
                f"linearizability search exceeded {max_states} states "
                f"on key {key!r} ({n} ops) — shrink the history")
        done_mask, state = node
        if done_mask & completed_mask == completed_mask:
            witness = []
            cur = node
            while cur in parent:
                cur, op_i = parent[cur]
                witness.append(ops[op_i].op_id)
            witness.reverse()
            return KeyReport(key, True, n, n_pending, witness)
        if (done_mask & completed_mask).bit_count() > \
                (best_mask & completed_mask).bit_count():
            best_mask = done_mask
        for i in _candidates(done_mask):
            try:
                new_state = _apply(ops[i].kind, ops[i].args, ops[i].result,
                                   completed[i], state)
            except _Illegal:
                continue
            if not completed[i] and new_state == state:
                # a pending op linearized as a state no-op is
                # indistinguishable from dropping it — don't branch
                # (this is what keeps pending-heavy CAS histories from
                # exploding: a maybe-applied cas that would fail here
                # contributes nothing)
                continue
            nxt = (done_mask | 1 << i, new_state)
            if nxt not in seen:
                parent.setdefault(nxt, (node, i))
                stack.append(nxt)

    stuck = [str(ops[i]) for i in range(n)
             if completed[i] and not best_mask >> i & 1][:6]
    return KeyReport(key, False, n, n_pending, stuck_ops=stuck)


def check_history(history: History, initial=None) -> Report:
    """Partition a history by key (linearizability is compositional over
    independent objects) and check each key's register history."""
    by_key: dict[bytes, list[Op]] = {}
    for op in history.ops():
        by_key.setdefault(op.key, []).append(op)
    keys = {k: check_register(v, initial=initial)
            for k, v in sorted(by_key.items())}
    return Report(all(r.ok for r in keys.values()), keys)


# ---------------------------------------------------------------------------
# targeted staleness assertion (read-mix soaks)
# ---------------------------------------------------------------------------

def check_stale_reads(ops: list[Op], seq_of) -> list[str]:
    """Fast, targeted no-stale-read assertion for monotone single-writer
    histories: a completed read must observe every write acked before
    the read was ISSUED.

    Requires the workload to write per-key monotonically increasing
    sequence values with at most ONE writer per key issuing writes in
    order (the read-mix soak's shape); ``seq_of(value) -> int`` extracts
    the sequence (return -1 for None/garbage).  A read is stale iff its
    observed sequence is below the highest sequence acked before its
    invoke AND is not explained by a maybe-applied (pending) write that
    could legally linearize later — a timed-out lower-seq write landing
    in the log after its successor is linearizable, not stale.

    Complements (does not replace) ``check_history``: the full checker
    proves the whole history, this one gives an O(n log n) verdict with
    a per-read violation message naming exactly which acked write the
    read missed — and stays tractable at read volumes that would swamp
    the exponential search.
    """
    import bisect

    violations: list[str] = []
    by_key: dict[bytes, list[Op]] = {}
    for op in ops:
        by_key.setdefault(op.key, []).append(op)
    for key, key_ops in sorted(by_key.items()):
        writes = [o for o in key_ops if o.kind == "w"]
        acked = sorted((o for o in writes if o.ret is not None),
                       key=lambda o: o.ret)
        # prefix-max of (seq, op) over the ack-ordered writes: the floor
        # for a read is one bisect on its invoke time, not a rescan of
        # every acked write (keeps the checker O(n log n) on the
        # read-heavy histories it exists for)
        ack_rets: list[float] = []
        prefix: list[tuple[int, Op]] = []
        best_seq, best_op = -1, None
        for w in acked:
            s = seq_of(w.args[1])
            if s > best_seq:
                best_seq, best_op = s, w
            ack_rets.append(w.ret)
            prefix.append((best_seq, best_op))
        # maybe-applied writes: seq -> earliest invoke (a pending write
        # may legally linearize any time after its invoke)
        pending_invoke: dict[int, float] = {}
        for w in writes:
            if w.ret is None:
                s = seq_of(w.args[1])
                if s not in pending_invoke or w.invoke < pending_invoke[s]:
                    pending_invoke[s] = w.invoke
        for read in key_ops:
            if read.kind != "r" or read.ret is None:
                continue
            # highest sequence fully acked before this read was issued
            i = bisect.bisect_right(ack_rets, read.invoke)
            if i == 0:
                continue
            floor_seq, floor_op = prefix[i - 1]
            got = seq_of(read.result)
            if got >= floor_seq:
                continue
            # a maybe-applied write invoked before the read returned may
            # legally linearize between the floor write and the read
            if pending_invoke.get(got, float("inf")) <= read.ret:
                continue
            violations.append(
                f"stale read on {key!r}: {read} observed seq {got} but "
                f"{floor_op} (seq {floor_seq}) was acked "
                f"{(read.invoke - floor_op.ret) * 1e3:.1f}ms before the "
                f"read was issued")
    return violations
