"""Trace plane: per-op spans + the protocol flight recorder.

Two observability primitives the rest of the system feeds:

**Tracer** — a cheap per-op span recorder for the serving hot path.
Every stage the benches used to probe externally (client queue →
``_StoreSender`` batch → ``kv_command_batch`` RPC → server validate →
propose → log flush → quorum ack → FSM apply → client ack) emits a span
when tracing is enabled; disabled, every call site costs ONE attribute
branch (``if _TRACE.enabled``) — the zero-cost claim ``make bench-gate``
enforces.  Retention is two-tier: a seeded probabilistic sample keeps a
deterministic fraction of ops end to end (full stage spans, context on
the wire), and an adaptive slow-op trigger force-retains any op slower
than a rolling p99 EMA even when the sampler skipped it — root span
with duration and a ``slow`` flag, because the tail is exactly what
you want attributed but universal candidacy must cost one clock read
per op, not a span pipeline (``make bench-gate``'s 5% sampled-tracing
budget is the contract).
Spans live in a bounded ring and export as Chrome trace-event JSON
(``chrome://tracing`` / perfetto-loadable) via bench/soak ``--trace``.

A trace context (one i64: ``seq << 1 | sampled``) rides the KV batch
item and the ``AppendEntriesRequest`` as TRAILING defaulted wire fields
— old decoders stop before them — so follower-side append/flush spans
join the same trace across processes.  A remote process records a
context-carrying span only when the sampled bit is set (the slow-op
trigger is a client-local decision; its staging buffer cannot span
processes).

**FlightRecorder** — a per-process bounded ring of protocol events
(elections, term changes, conf-change stage transitions, quiesce/wake,
leadership evacuations, health transitions, fence-round failures, shed
bounces) that is ALWAYS on: appends are O(1) into a deque and the rare
events it records are exactly the ones you need after an incident.
``describe()`` renders the tail for SIGUSR2 dumps (util/describer);
``note_anomaly`` snapshots the ring on a detected anomaly (SICK
transition, election storm, soak oracle failure) so the state *leading
up to* the incident survives ring churn.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from typing import Optional

from tpuraft_torch.util import describer

# perf_counter is the span clock (monotonic, ns resolution); one wall
# anchor taken at configure() maps it to absolute µs for the export
_pc = time.perf_counter


# graftcheck: loop-confined — created and consumed only by the Tracer
# (itself loop-confined below); executor threads never hold one
class _Staged:
    """One locally-originated op, staged until end_op decides retention
    (sampled => always; slow => force-retained).  Only SAMPLED ops
    buffer child spans — an unsampled op is duration-only (``spans``
    stays None), so the universal slow-op candidacy costs one clock
    read and two dict ops per op, not a span pipeline (the overhead
    gate's 5% budget is the contract)."""

    __slots__ = ("name", "proc", "t0", "sampled", "spans")

    def __init__(self, name: str, proc: str, t0: float, sampled: bool):
        self.name = name
        self.proc = proc
        self.t0 = t0
        self.sampled = sampled
        self.spans: Optional[list] = [] if sampled else None


# graftcheck: loop-confined — begin_op/end_op/span all run on the
# owning process's event loop (executor threads measure t0/t1 but the
# record call happens after the await returns); the ring deque is
# additionally safe for the exposition thread's len()/iteration
class Tracer:
    """Bounded-ring span recorder with seeded sampling + slow-op
    force-retention.  One module-level instance per process
    (:data:`TRACER`); components tag spans with their own ``proc``
    identity so an in-proc multi-store bench still attributes stages to
    client / leader store / follower store."""

    def __init__(self) -> None:
        self.enabled = False
        self.sample_rate = 0.01
        self._rng = random.Random(0)
        self._ring: deque = deque(maxlen=4096)
        self._staged: dict[int, _Staged] = {}
        self._max_staged = 1024
        self._next_seq = 1
        self._wall0 = time.time()
        self._pc0 = _pc()
        # adaptive slow-op trigger: asymmetric EMA tracking ~p99 of op
        # durations; an op above the estimate is retained even when the
        # sampler skipped it.  Warmup gate: the estimate means nothing
        # until it has seen a population.
        self.slow_trigger = True
        self._p99_ema = 0.0
        self._q_alpha = 0.05
        self._durs_seen = 0
        self._warmup = 100
        # counters (exposition / tests)
        self.ops_seen = 0
        self.ops_sampled = 0
        self.ops_slow_retained = 0
        self.ops_dropped = 0
        self.spans_recorded = 0

    # -- lifecycle -----------------------------------------------------------

    def configure(self, enabled: bool = True, sample_rate: float = 0.01,
                  seed: int = 0, ring: int = 4096,
                  slow_trigger: bool = True) -> "Tracer":
        """(Re)arm the tracer.  Seeded: two tracers configured alike
        sample the same op sequence — bench A/B runs compare like for
        like."""
        self.enabled = enabled
        self.sample_rate = sample_rate
        self._rng = random.Random(seed)
        if ring != self._ring.maxlen:
            self._ring = deque(self._ring, maxlen=ring)
        self.slow_trigger = slow_trigger
        # NOTE: the wall/perf anchor is NOT re-taken here — spans store
        # offsets relative to the anchor, so re-anchoring mid-process
        # would shift every already-recorded span in the export
        return self

    def reset(self) -> None:
        """Drop all recorded/staged spans and counters (test isolation)."""
        self._ring.clear()
        self._staged.clear()
        self._wall0 = time.time()
        self._pc0 = _pc()
        self._p99_ema = 0.0
        self._durs_seen = 0
        self.ops_seen = self.ops_sampled = 0
        self.ops_slow_retained = self.ops_dropped = 0
        self.spans_recorded = 0

    # -- op lifecycle (locally-originated traces) ----------------------------

    def begin_op(self, name: str = "op", proc: str = "client") -> int:
        """Open one op's trace; returns its context (0 = not traced —
        tracing disabled, or the staging buffer is full and the sampler
        skipped it).  The context's low bit is the sampled flag remote
        processes key retention on."""
        if not self.enabled:
            return 0
        self.ops_seen += 1
        sampled = self._rng.random() < self.sample_rate
        if not sampled and (not self.slow_trigger
                            or len(self._staged) >= self._max_staged):
            return 0
        tid = (self._next_seq << 1) | (1 if sampled else 0)
        self._next_seq += 1
        if sampled:
            self.ops_sampled += 1
        self._staged[tid] = _Staged(name, proc, _pc(), sampled)
        while len(self._staged) > self._max_staged:
            # evict the oldest abandoned op (an end_op that never came)
            self._staged.pop(next(iter(self._staged)))
        return tid

    def end_op(self, tid: int, **args) -> float:
        """Close an op: emit its root span and decide retention.
        Returns the op duration in seconds (0.0 if untraced)."""
        if not tid:
            return 0.0
        st = self._staged.pop(tid, None)
        if st is None:
            return 0.0
        t1 = _pc()
        dur = t1 - st.t0
        slow = self._note_dur(dur)
        if st.sampled or slow:
            if slow and not st.sampled:
                # force-retained by the slow trigger: the root span
                # (with duration + slow flag) is what survives — child
                # attribution exists only for sampled ops
                self.ops_slow_retained += 1
                args = dict(args, slow=True)
            self._emit(tid, st.name, st.proc, st.t0, t1, args)
            for span in st.spans or ():
                self._ring.append(span)
                self.spans_recorded += 1
        else:
            self.ops_dropped += 1
        return dur

    def span(self, tid: int, name: str, t0: float, t1: float,
             proc: str = "", **args) -> None:
        """Record one stage span of trace ``tid`` covering perf_counter
        interval [t0, t1].  Locally-staged traces buffer (retention
        decided at end_op); a remote context records iff sampled."""
        if not tid:
            return
        st = self._staged.get(tid)
        if st is not None:
            if st.spans is not None:
                st.spans.append(self._event(tid, name, proc or st.proc,
                                            t0, t1, args))
        elif tid & 1:
            self._emit(tid, name, proc or "remote", t0, t1, args)

    # -- internals -----------------------------------------------------------

    def _note_dur(self, dur: float) -> bool:
        """Feed the rolling p99 estimate; True = this op is slow (above
        the warmed estimate)."""
        self._durs_seen += 1
        if self._p99_ema == 0.0:
            self._p99_ema = dur
            return False
        slow = (self.slow_trigger and self._durs_seen > self._warmup
                and dur > self._p99_ema)
        # asymmetric quantile EMA: rise on the 1% above, fall 99x slower
        # on the mass below — settles near the p99 of the stream
        if dur > self._p99_ema:
            self._p99_ema += self._q_alpha * (dur - self._p99_ema)
        else:
            self._p99_ema -= (self._q_alpha / 99.0) * (self._p99_ema - dur)
        return slow

    def _event(self, tid: int, name: str, proc: str, t0: float, t1: float,
               args: dict) -> tuple:
        return (tid, name, proc, t0 - self._pc0, max(0.0, t1 - t0),
                args or None)

    def _emit(self, tid: int, name: str, proc: str, t0: float, t1: float,
              args: dict) -> None:
        self._ring.append(self._event(tid, name, proc, t0, t1, args))
        self.spans_recorded += 1

    # -- export / introspection ---------------------------------------------

    def spans(self, tid: Optional[int] = None) -> list[dict]:
        """Retained spans as dicts (newest last); optionally one trace's."""
        out = []
        for ev_tid, name, proc, rel0, dur, args in list(self._ring):
            if tid is not None and ev_tid != tid:
                continue
            out.append({"trace_id": ev_tid, "seq": ev_tid >> 1,
                        "name": name, "proc": proc,
                        "ts_s": rel0, "dur_s": dur,
                        "args": dict(args) if args else {}})
        return out

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event ("X" complete events + process_name
        metadata) — the format chrome://tracing and perfetto load."""
        pids: dict[str, int] = {}
        events: list[dict] = []
        for ev_tid, name, proc, rel0, dur, args in list(self._ring):
            pid = pids.get(proc)
            if pid is None:
                pid = pids[proc] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": proc}})
            ev = {"ph": "X", "name": name, "pid": pid,
                  "tid": ev_tid >> 1,
                  "ts": round((self._wall0 + rel0) * 1e6, 3),
                  "dur": round(dur * 1e6, 3),
                  "args": {"trace_id": ev_tid, **(args or {})}}
            events.append(ev)
        return events

    def export_chrome(self, path: str) -> int:
        """Write the ring as a perfetto-loadable JSON file; returns the
        number of span events written."""
        events = self.chrome_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return sum(1 for e in events if e["ph"] == "X")

    def counters(self) -> dict:
        """Monotonic series only (Prometheus 'counter' semantics —
        rate()/increase() must never see a decrease)."""
        return {
            "trace_ops_seen": self.ops_seen,
            "trace_ops_sampled": self.ops_sampled,
            "trace_ops_slow_retained": self.ops_slow_retained,
            "trace_ops_dropped": self.ops_dropped,
            "trace_spans_recorded": self.spans_recorded,
        }

    def gauges(self) -> dict:
        """Point-in-time series (toggles, ring occupancy, EMAs)."""
        return {
            "trace_enabled": int(self.enabled),
            "trace_ring_spans": len(self._ring),
            "trace_slow_ema_ms": round(self._p99_ema * 1000.0, 3),
        }

    def stats(self) -> dict:
        """Everything, merged — the bench/soak report blob."""
        return {**self.counters(), **self.gauges()}

    def describe(self) -> str:
        c = self.stats()
        return (f"Tracer<enabled={self.enabled} rate={self.sample_rate} "
                f"ops={c['trace_ops_seen']} sampled={c['trace_ops_sampled']} "
                f"slow_retained={c['trace_ops_slow_retained']} "
                f"ring={c['trace_ring_spans']} "
                f"p99_ema={c['trace_slow_ema_ms']}ms>")


# -- trace-context wire helpers ----------------------------------------------
# One i64 per item/entry, little-endian, concatenated; b"" = untraced.
# Riding TRAILING defaulted wire fields keeps old decoders compatible
# (they stop before the field) and costs zero bytes when tracing is off.

import struct as _struct

_CTX = _struct.Struct("<q")


def store_proc(server_id) -> str:
    """The canonical span 'proc' identity for a store-side component.
    ONE derivation: cross-stage correlation (and the bench's
    leader-proc matching) requires every stage of one store to render
    the identical string — four call sites re-deriving it from
    slightly different server_id sources would silently split a
    store's spans across two 'processes' in the export."""
    return f"store:{server_id}"


def wire_ctx(tid: int) -> int:
    """The context an op PROPAGATES downstream: sampled ops carry their
    tid (full stage attribution), unsampled slow-candidates carry 0 —
    their only artifact is the client-side root span, so the serving
    path stays untouched for the 1-sample_rate majority."""
    return tid if tid & 1 else 0


def pack_ctx(tids: list[int]) -> bytes:
    """Pack per-item trace contexts; all-zero packs to b"" (no wire
    cost on the untraced path)."""
    if not any(tids):
        return b""
    return b"".join(_CTX.pack(t) for t in tids)


def unpack_ctx(blob: bytes, n: int) -> list[int]:
    """Unpack ``n`` per-item contexts; a missing/short blob (old sender,
    tracing off) yields zeros for every item."""
    if not blob or len(blob) < n * _CTX.size:
        return [0] * n
    return [_CTX.unpack_from(blob, i * _CTX.size)[0] for i in range(n)]


def entry_ctx(entries) -> bytes:
    """Pack the trace contexts of a log-entry batch for the
    AppendEntriesRequest trailing field."""
    return pack_ctx([e.trace_id for e in entries])


def adopt_entry_ctx(entries, blob: bytes) -> None:
    """Follower side: stamp wire-borne contexts onto decoded entries so
    their append/flush spans join the originating trace."""
    if not blob:
        return
    tids = unpack_ctx(blob, len(entries))
    for e, tid in zip(entries, tids):
        if tid:
            e.trace_id = tid


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Per-process bounded ring of protocol events + anomaly snapshots.

    Always on: the events it records (elections, conf-change stages,
    health transitions, evacuations, quiesce/wake, fence failures, shed
    bounces) happen at incident rate, not op rate, and a deque append
    is cheap enough to never gate.  Thread-safe: health transitions can
    arrive from the store's health task while node events arrive from
    RPC handlers on the same loop, and SIGUSR2 dumps from the signal
    frame.
    """

    def __init__(self, capacity: int = 2048) -> None:
        self._lock = threading.Lock()
        # writes serialized under _lock; reads are DELIBERATELY lock-free
        # (GIL-atomic deque snapshots via _snapshot) so dump()/describe()
        # stay safe from a SIGUSR2 frame that interrupted a record() call
        # holding the lock on this very thread
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: _lock (writes)
        # anomaly snapshots: the ring tail AT the moment the anomaly
        # fired (ring churn after the incident must not erase the lead-up)
        self.anomalies: deque = deque(maxlen=8)     # guarded-by: _lock (writes)
        # election-storm detection: recent election_start timestamps per
        # group, pruned to the window
        self._elections: dict[str, deque] = {}      # guarded-by: _lock
        self._storm_last: dict[str, float] = {}     # guarded-by: _lock
        # coalescing windows for flood-prone event kinds (shed bounces
        # at request rate, mass hibernation sweeps), keyed per
        # (kind, group) so one store's flood can't swallow another's
        # first event or claim its suppressed count in the dump:
        # (kind, group) -> [window_start_monotonic, suppressed_count]
        self._coalesce: dict[tuple, list] = {}      # guarded-by: _lock
        self.storm_threshold = 5      # elections ...
        self.storm_window_s = 10.0    # ... within this window = a storm
        self.events_recorded = 0

    def record(self, kind: str, group: str = "", **detail) -> None:
        now = time.time()
        with self._lock:
            self._ring.append((now, kind, group, detail))
            self.events_recorded += 1
            if kind == "election_start" and group:
                self._note_election_locked(group, now)

    def _note_election_locked(self, group: str, now: float) -> None:
        dq = self._elections.get(group)
        if dq is None:
            dq = self._elections[group] = deque(maxlen=32)
            # bound the per-group map itself (region churn)
            if len(self._elections) > 512:
                self._elections.pop(next(iter(self._elections)))
        dq.append(now)
        while dq and now - dq[0] > self.storm_window_s:
            dq.popleft()
        if len(dq) >= self.storm_threshold:
            # once per window per group — a storm must not flood the
            # anomaly buffer with one snapshot per extra election
            if now - self._storm_last.get(group, 0.0) > self.storm_window_s:
                self._storm_last[group] = now
                self._anomaly_locked(
                    "election_storm",
                    f"group {group}: {len(dq)} elections in "
                    f"{self.storm_window_s:.0f}s")

    def record_coalesced(self, kind: str, group: str = "",
                         window_s: float = 1.0, per_group: bool = True,
                         **detail) -> None:
        """Leading-edge rate-bounded record for event kinds that can
        arrive in floods (a SICK store shedding at request rate, a
        hibernation sweep quiescing thousands of groups): the first
        occurrence in a window records immediately with its detail,
        the rest just count — the next recorded event of the kind
        carries ``suppressed=N`` plus ``suppressed_prior_s`` (how far
        back that suppressed window started), so a long-past flood's
        count reads as history, not as part of the new event.  Without
        coalescing, one incident's identical rows would evict the
        ring's entire lead-up (the exact history the recorder exists
        to keep).

        Windows are per (kind, group) by default — one source's flood
        must not swallow another's first event or claim its suppressed
        count in the dump.  Kinds whose flood IS many distinct groups
        at once (a hibernation sweep: every group quiesces exactly
        once, so each per-group window would be a leading edge and the
        sweep floods anyway) pass ``per_group=False`` to share one
        window per kind; the suppressed count then aggregates across
        groups and the recorded row's group is just the window's first
        trigger."""
        now = time.monotonic()
        key = (kind, group if per_group else "")
        with self._lock:
            ent = self._coalesce.get(key)
            if ent is not None and now - ent[0] < window_s:
                ent[1] += 1
                return
            if ent is not None and ent[1]:
                # time-stamp the carried count against ITS window — an
                # unrelated event hours later must not read as a flood
                detail = dict(detail, suppressed=ent[1],
                              suppressed_prior_s=round(now - ent[0], 1))
            if len(self._coalesce) > 1024:
                # bound the (kind, group) map itself (region churn)
                self._coalesce.pop(next(iter(self._coalesce)))
            self._coalesce[key] = [now, 0]
            self._ring.append((time.time(), kind, group, detail))
            self.events_recorded += 1

    def note_anomaly(self, reason: str, detail: str = "") -> None:
        """Snapshot the ring: something is wrong (SICK transition, soak
        oracle failure) and the lead-up events must survive churn."""
        with self._lock:
            self._anomaly_locked(reason, detail)

    def _anomaly_locked(self, reason: str, detail: str) -> None:
        # snapshot RAW tuples only — rendering 128 formatted lines here
        # would stall the event loop under the lock at the exact moment
        # (an election storm) the recorder is busiest; strings are built
        # lazily at dump/anomaly_report time
        self._ring.append((time.time(), "anomaly", "",
                           {"reason": reason, "detail": detail}))
        self.anomalies.append({
            "ts": time.time(),
            "reason": reason,
            "detail": detail,
            "raw_events": list(self._ring)[-128:],
        })

    def _snapshot(self, src) -> list:
        """LOCK-FREE read of a deque: dump()/describe() must be safe
        from a SIGNAL frame that may have interrupted a record() call
        holding ``_lock`` on this very thread — taking the lock there
        self-deadlocks the process.  ``list(deque)`` is GIL-safe except
        for a concurrent-mutation RuntimeError; retry, degrade to
        empty (a best-effort dump beats a hung node)."""
        for _ in range(4):
            try:
                return list(src)
            except RuntimeError:
                continue
        return []

    def events(self, last: int = 0) -> list[tuple]:
        evs = self._snapshot(self._ring)
        return evs[-last:] if last else evs

    @staticmethod
    def _render(evs: list) -> list[str]:
        out = []
        for ts, kind, group, detail in evs:
            stamp = time.strftime("%H:%M:%S", time.localtime(ts))
            extra = " ".join(f"{k}={v}" for k, v in detail.items())
            out.append(f"{stamp}.{int(ts % 1 * 1000):03d} {kind:<16} "
                       f"{group or '-':<24} {extra}".rstrip())
        return out

    def dump(self, last: int = 256) -> str:
        """Structured text dump of the event tail (SIGUSR2 / soak
        failure attachment).  Lock-free: callable from a signal frame."""
        lines = self._render(self.events(last))
        hdr = (f"--- flight recorder: {len(lines)} recent events, "
               f"{self.events_recorded} total, "
               f"{len(self.anomalies)} anomalies ---")
        return "\n".join([hdr] + lines)

    def anomaly_report(self) -> list[dict]:
        """Anomaly snapshots for machine-readable attachment (the
        soak's failure report); raw tuples render here, off the
        recording path."""
        return [{"ts": a["ts"], "reason": a["reason"],
                 "detail": a["detail"],
                 "events": self._render(a["raw_events"])}
                for a in self._snapshot(self.anomalies)]

    def counters(self) -> dict:
        """Monotonic series (Prometheus counter semantics); lock-free
        int/len reads (the exposition thread must never contend the
        recording path)."""
        return {"recorder_events": self.events_recorded}

    def gauges(self) -> dict:
        return {
            "recorder_ring": len(self._ring),
            "recorder_anomalies": len(self.anomalies),
        }

    def stats(self) -> dict:
        return {**self.counters(), **self.gauges()}

    def describe(self) -> str:
        return self.dump(last=64)


# Module-level singletons: one tracer + one recorder per process.  All
# components record into these; the describer renders them on SIGUSR2.
TRACER = Tracer()
RECORDER = FlightRecorder()
describer.register(TRACER)
describer.register(RECORDER)
