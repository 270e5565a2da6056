"""Store health scoring: gray-failure detection from hot-path signals.

Fail-slow is the production failure mode the chaos harness never
modeled: a store with a stalling disk or a saturated CPU stays "alive"
to every existing check (it acks heartbeats, eventually) while every
group it leads limps at 100x latency.  *CD-Raft* (PAPERS.md) treats
degraded links as the normal case and routes around them;
*Compartmentalization* isolates stages so one slow component cannot
stall the rest — this module gives stores the same posture: score each
store's health from signals the hot path ALREADY produces, and let the
mitigation layers (leadership evacuation, read re-routing, serving-
plane shedding — tpuraft/rheakv/store_engine.py, kv_service.py,
pd_server.py) act on the score.

Signals (no new RPCs, no polling probes):
  - **disk**: append+fsync latency of every log flush round
    (``LogManager._flush_loop`` times the storage call; the multilog
    group-commit feeds its in-thread fsync duration) plus the AGE of a
    still-in-flight flush — a fully hung fsync produces no completed
    sample, so the EMA alone would never notice it;
  - **peer RTT**: ack round-trip of every beat-plane RPC the
    HeartbeatHub / ReadConfirmBatcher / classic heartbeat path already
    sends, per destination endpoint;
  - **apply backlog**: committed-minus-applied depth the FSMCaller
    already tracks.

Scoring is DETERMINISTIC given the same inputs: ``evaluate()`` folds
the EMAs through fixed thresholds into {HEALTHY, DEGRADED, SICK} with
evaluation-count hysteresis (a score only worsens after
``worsen_after`` consecutive bad evaluations and only improves after
``recover_after`` consecutive good ones), so one writeback spike never
flaps leadership and a recovering store must PROVE health before the
evacuation brake releases.  No wall-clock policy: hysteresis counts
evaluation rounds, not seconds — a seeded test drives evaluate() by
hand and gets byte-identical transitions.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

HEALTHY = "healthy"
DEGRADED = "degraded"
SICK = "sick"

_LEVELS = {HEALTHY: 0, DEGRADED: 1, SICK: 2}

# disk-pressure states (DiskBudget) — same hysteresis machinery, its
# own axis: pressure feeds health as an external FLOOR (NEAR_FULL =>
# DEGRADED, FULL => SICK) rather than mixing into the latency signals
PRESSURE_OK = "ok"
PRESSURE_NEAR_FULL = "near_full"
PRESSURE_FULL = "full"

_PRESSURE_LEVELS = {PRESSURE_OK: 0, PRESSURE_NEAR_FULL: 1,
                    PRESSURE_FULL: 2}


@dataclass
class HealthOptions:
    """Thresholds + hysteresis for one store's tracker.

    Defaults target the same-host chaos/soak envelope (sub-ms healthy
    fsyncs); production disks tune disk_* up.  See docs/operations.md
    "Gray-failure runbook"."""

    # disk: flush-round latency EMA (ms) — append + fsync, as observed
    # by the LogManager flush loop / multilog group commit
    disk_degraded_ms: float = 25.0
    disk_sick_ms: float = 120.0
    # a flush IN FLIGHT longer than this is a stall even with a clean
    # EMA (a hung fsync completes no sample); scored SICK directly
    disk_stall_ms: float = 500.0
    # peer ack RTT EMA (ms): scores the PEER endpoint, not this store
    peer_degraded_ms: float = 50.0
    peer_sick_ms: float = 250.0
    # apply backlog: committed-minus-applied entries (EMA) across groups
    apply_degraded: float = 256.0
    apply_sick: float = 2048.0
    # event-loop scheduling lag EMA (ms): delay between when a timer
    # callback was DUE and when the loop actually ran it — the direct
    # signal of a saturated loop (the single-process store fabric's
    # ceiling; see docs/operations.md "Process topology runbook").
    # Thresholds are deliberately loose: test topologies multiplex many
    # stores on one loop and boot storms spike lag transiently — the
    # hysteresis plus these bounds keep that from flapping leadership.
    loop_degraded_ms: float = 250.0
    loop_sick_ms: float = 2000.0
    # probe cadence (4 extra callbacks/s at the default)
    loop_probe_interval_ms: float = 250.0
    # hysteresis (evaluation rounds, not seconds): worsen fast, recover
    # slowly — a DEGRADED-but-recovering store keeps its leaders
    worsen_after: int = 2
    recover_after: int = 5
    # EMA smoothing factor for new samples
    alpha: float = 0.25


# Fed from EXECUTOR threads (FileLogStorage appends run off-loop; the
# multilog group commit times its fsync in the executor) as well as the
# event loop — the one piece of tracker state that genuinely crosses
# threads, so it carries its own lock while the tracker stays
# loop-confined.
class DiskLatencyProbe:
    """Append/fsync latency EMA + in-flight stall age for one store."""

    def __init__(self, alpha: float = 0.25, clock=time.monotonic):
        self._alpha = alpha
        self._clock = clock
        self._lock = threading.Lock()
        self._ema_ms = 0.0            # guarded-by: _lock
        self._samples = 0             # guarded-by: _lock
        # flush begin timestamps keyed by token (in-flight rounds);
        # a hung fsync never ends its token, and its AGE is the signal
        self._inflight: dict[int, float] = {}   # guarded-by: _lock
        self._next_token = 0          # guarded-by: _lock

    def begin(self) -> int:
        """A flush round started; returns the token for :meth:`end`.
        begin/end feed ONLY the in-flight stall age — a hung fsync
        completes no sample, and its growing age is the signal."""
        with self._lock:
            self._next_token += 1
            tok = self._next_token
            self._inflight[tok] = self._clock()
            return tok

    def end(self, token: int) -> None:
        """The round completed (clears its stall-age token).  The EMA
        is deliberately NOT fed here: end-to-end round time includes
        executor-queue and event-loop wait, and in a co-hosted process
        one store's genuinely slow disk saturating the shared executor
        would score every OTHER store's disk sick too (observed as a
        mutual-evacuation leadership storm in the gray A/B bench).
        Feed the EMA with :meth:`note` from IN-THREAD measurements."""
        with self._lock:
            self._inflight.pop(token, None)

    def note(self, dur_s: float) -> None:
        """One completed disk op, measured IN the thread that did the
        I/O (LogManager's executor wrapper, the multilog group-commit's
        fsync timer) — the uncontaminated latency of THIS store's
        disk."""
        with self._lock:
            self._note_locked(dur_s * 1000.0)

    def _note_locked(self, ms: float) -> None:
        if self._samples == 0:
            self._ema_ms = ms
        else:
            self._ema_ms += self._alpha * (ms - self._ema_ms)
        self._samples += 1

    def snapshot(self) -> tuple[float, float, int]:
        """(ema_ms, oldest_inflight_age_ms, samples) — one locked read."""
        with self._lock:
            age = 0.0
            if self._inflight:
                now = self._clock()
                age = (now - min(self._inflight.values())) * 1000.0
            return self._ema_ms, age, self._samples


# graftcheck: loop-confined — armed, ticked and sampled on the owning
# store's event loop (call_later chain); stop() flips a flag the next
# tick observes
class LoopLagProbe:
    """Event-loop scheduling delay EMA: a ``call_later`` chain measures
    (actual - expected) run time of each tick.  A loop saturated by
    callback herds runs timers LATE — that lateness is exactly the
    latency every other callback on the loop is paying, so it scores
    the store's serving plane the way the disk probe scores its log
    plane.  Samples feed an EMA (+ a peak-hold max for triage);
    ``snapshot()`` is the tracker's read."""

    def __init__(self, alpha: float = 0.25, interval_s: float = 0.25,
                 clock=time.monotonic):
        self._alpha = alpha
        self._interval = interval_s
        self._clock = clock
        self._ema_ms = 0.0
        self._max_ms = 0.0
        self._samples = 0
        self._expected = 0.0
        self._handle = None
        self._running = False

    def start(self) -> None:
        """Arm the chain on the CURRENT running loop (idempotent)."""
        if self._running:
            return
        import asyncio

        self._running = True
        self._arm(asyncio.get_running_loop())

    def stop(self) -> None:
        self._running = False
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def _arm(self, loop) -> None:
        self._expected = self._clock() + self._interval
        self._handle = loop.call_later(self._interval, self._tick, loop)

    def _tick(self, loop) -> None:
        if not self._running:
            return
        lag = (self._clock() - self._expected) * 1000.0
        if lag < 0.0:
            lag = 0.0
        if self._samples == 0:
            self._ema_ms = lag
        else:
            self._ema_ms += self._alpha * (lag - self._ema_ms)
        if lag > self._max_ms:
            self._max_ms = lag
        self._samples += 1
        self._arm(loop)

    def snapshot(self) -> tuple[float, float, int]:
        """(ema_ms, max_ms, samples)."""
        return self._ema_ms, self._max_ms, self._samples


# graftcheck: loop-confined — owned by HealthTracker (self + per-peer
# rows), folded only on the store's event loop; the cross-thread disk
# signal stays inside the LOCKED DiskLatencyProbe above
class _Hysteresis:
    """Evaluation-count hysteresis around a raw level stream.

    ``levels`` maps level name -> rank (worse = higher); defaults to the
    health axis, and DiskBudget reuses the machinery with the pressure
    axis (OK/NEAR_FULL/FULL)."""

    __slots__ = ("level", "_pending", "_streak", "_up", "_down", "_levels")

    def __init__(self, worsen_after: int, recover_after: int,
                 levels: dict | None = None, initial: str = HEALTHY):
        self._levels = levels if levels is not None else _LEVELS
        self.level = initial
        self._pending = initial
        self._streak = 0
        self._up = max(1, worsen_after)
        self._down = max(1, recover_after)

    def fold(self, raw: str) -> str:
        if raw == self.level:
            self._pending, self._streak = raw, 0
            return self.level
        if raw != self._pending:
            self._pending, self._streak = raw, 0
        self._streak += 1
        need = self._up if self._levels[raw] > self._levels[self.level] \
            else self._down
        if self._streak >= need:
            self.level = raw
            self._streak = 0
        return self.level


# graftcheck: loop-confined — note_peer_rtt/note_apply_depth/evaluate
# run on the owning store's event loop (hub acks, FSM caller, the
# store's health task); only the disk probe above crosses threads
class HealthTracker:
    """One store's {HEALTHY, DEGRADED, SICK} score + per-peer scores."""

    def __init__(self, opts: HealthOptions | None = None,
                 clock=time.monotonic, label: str = ""):
        self.opts = opts or HealthOptions()
        # flight-recorder identity (the owning store's endpoint)
        self.label = label
        self.disk = DiskLatencyProbe(self.opts.alpha, clock=clock)
        # event-loop lag probe: started by the owning store's engine
        # (StoreEngine.start) — it needs a running loop to arm
        self.loop_lag = LoopLagProbe(
            self.opts.alpha,
            interval_s=self.opts.loop_probe_interval_ms / 1000.0,
            clock=clock)
        self._self_hyst = _Hysteresis(self.opts.worsen_after,
                                      self.opts.recover_after)
        # peer endpoint -> (rtt ema ms, samples, hysteresis)
        self._peers: dict[str, list] = {}
        self._apply_ema = 0.0
        self._apply_samples = 0
        self.evaluations = 0
        # observability: evaluations that saw each level, raw cause of
        # the current level ("disk" / "stall" / "apply" / "")
        self.level_counts = {HEALTHY: 0, DEGRADED: 0, SICK: 0}
        self.cause = ""
        # external raw floor (disk pressure): the DiskBudget ladder
        # pins the raw level at least this bad each round, so NEAR_FULL
        # rides the existing health heartbeat wire to the PD (stops new
        # leader placement) and FULL engages the SICK machinery
        # (evacuation + shed) without a second reporting channel
        self._floor = HEALTHY
        self._floor_cause = ""

    # -- signal intake -------------------------------------------------------

    def set_floor(self, level: str, cause: str = "") -> None:
        """Pin the RAW level at least this bad (hysteresis still
        applies).  HEALTHY clears the floor."""
        self._floor = level
        self._floor_cause = cause if level != HEALTHY else ""

    def note_peer_rtt(self, endpoint: str, rtt_s: float) -> None:
        ent = self._peers.get(endpoint)
        ms = rtt_s * 1000.0
        if ent is None:
            self._peers[endpoint] = [ms, 1, _Hysteresis(
                self.opts.worsen_after, self.opts.recover_after)]
            return
        ent[0] += self.opts.alpha * (ms - ent[0])
        ent[1] += 1

    def note_apply_depth(self, depth: int) -> None:
        self._apply_ema += self.opts.alpha * (depth - self._apply_ema)
        self._apply_samples += 1

    # -- scoring -------------------------------------------------------------

    def _raw_self(self) -> tuple[str, str]:
        o = self.opts
        ema, stall_age, samples = self.disk.snapshot()
        if stall_age >= o.disk_stall_ms:
            return SICK, "stall"
        level, cause = HEALTHY, ""
        if samples:
            if ema >= o.disk_sick_ms:
                level, cause = SICK, "disk"
            elif ema >= o.disk_degraded_ms:
                level, cause = DEGRADED, "disk"
        if self._apply_samples and _LEVELS[level] < _LEVELS[SICK]:
            if self._apply_ema >= o.apply_sick:
                level, cause = SICK, "apply"
            elif self._apply_ema >= o.apply_degraded \
                    and _LEVELS[level] < _LEVELS[DEGRADED]:
                level, cause = DEGRADED, "apply"
        lag_ema, _lag_max, lag_samples = self.loop_lag.snapshot()
        if lag_samples and _LEVELS[level] < _LEVELS[SICK]:
            if lag_ema >= o.loop_sick_ms:
                level, cause = SICK, "loop"
            elif lag_ema >= o.loop_degraded_ms \
                    and _LEVELS[level] < _LEVELS[DEGRADED]:
                level, cause = DEGRADED, "loop"
        if _LEVELS[self._floor] > _LEVELS[level]:
            level, cause = self._floor, self._floor_cause
        return level, cause

    def evaluate(self) -> str:
        """One scoring round: fold the current EMAs through the
        thresholds and the hysteresis; returns the (hysteretic) level.
        Call at a steady cadence (the store's health task) — hysteresis
        counts these calls, so cadence x worsen_after bounds detection
        latency."""
        from tpuraft_torch.util.trace import RECORDER

        self.evaluations += 1
        prev = self._self_hyst.level
        raw, cause = self._raw_self()
        level = self._self_hyst.fold(raw)
        if level == raw:
            self.cause = cause
        if level != prev:
            # flight recorder: health transitions are incident markers,
            # and a SICK transition snapshots the ring — the lead-up
            # (elections, shed bounces, fence failures) must survive
            # ring churn for post-hoc triage
            RECORDER.record("health", self.label,
                            level=level, was=prev, cause=self.cause)
            if level == SICK:
                RECORDER.note_anomaly(
                    "sick_transition",
                    f"{self.label or 'store'}: {prev} -> {level} "
                    f"(cause={self.cause or '?'})")
        self.level_counts[level] += 1
        for ent in self._peers.values():
            o = self.opts
            if ent[0] >= o.peer_sick_ms:
                praw = SICK
            elif ent[0] >= o.peer_degraded_ms:
                praw = DEGRADED
            else:
                praw = HEALTHY
            ent[2].fold(praw)
        return level

    def score(self) -> str:
        """Current hysteretic level (no new evaluation round)."""
        return self._self_hyst.level

    def peer_score(self, endpoint: str) -> str:
        ent = self._peers.get(endpoint)
        return ent[2].level if ent is not None else HEALTHY

    def slow_peers(self) -> list[str]:
        """Endpoints currently scored worse than HEALTHY."""
        return sorted(ep for ep, ent in self._peers.items()
                      if ent[2].level != HEALTHY)

    # -- observability -------------------------------------------------------

    def counters(self) -> dict:
        ema, stall_age, samples = self.disk.snapshot()
        lag_ema, lag_max, lag_samples = self.loop_lag.snapshot()
        return {
            "health_level": _LEVELS[self.score()],
            "health_evaluations": self.evaluations,
            "health_disk_ema_ms": round(ema, 3),
            "health_disk_inflight_ms": round(stall_age, 1),
            "health_disk_samples": samples,
            "health_apply_ema": round(self._apply_ema, 1),
            "health_loop_lag_ms": round(lag_ema, 3),
            "health_loop_lag_max_ms": round(lag_max, 1),
            "health_loop_samples": lag_samples,
            "health_slow_peers": len(self.slow_peers()),
        }

    def register_gauges(self, metrics) -> None:
        metrics.gauge("health.level", lambda: _LEVELS[self.score()])
        metrics.gauge("health.disk_ema_ms",
                      lambda: self.disk.snapshot()[0])
        metrics.gauge("health.disk_inflight_ms",
                      lambda: self.disk.snapshot()[1])
        metrics.gauge("health.apply_ema", lambda: self._apply_ema)
        metrics.gauge("health.loop_lag_ms",
                      lambda: self.loop_lag.snapshot()[0])
        metrics.gauge("health.loop_lag_max_ms",
                      lambda: self.loop_lag.snapshot()[1])
        metrics.gauge("health.slow_peers",
                      lambda: float(len(self.slow_peers())))

    def describe(self) -> str:
        ema, stall_age, samples = self.disk.snapshot()
        lag_ema, lag_max, _n = self.loop_lag.snapshot()
        peers = ", ".join(
            f"{ep}={ent[2].level}:{ent[0]:.1f}ms"
            for ep, ent in sorted(self._peers.items())) or "-"
        return (f"HealthTracker<{self.score()} cause={self.cause or '-'} "
                f"disk_ema={ema:.2f}ms inflight={stall_age:.0f}ms "
                f"samples={samples} apply_ema={self._apply_ema:.1f} "
                f"loop_lag={lag_ema:.1f}ms max={lag_max:.0f}ms "
                f"evals={self.evaluations} peers=[{peers}]>")


# ---------------------------------------------------------------------------
# disk-pressure accounting (capacity, not latency)
# ---------------------------------------------------------------------------


@dataclass
class DiskBudgetOptions:
    """Thresholds + hysteresis for one store's capacity tracker.

    See docs/operations.md "Disk-pressure runbook"."""

    # byte budget for the store's data directory.  0 = derive capacity
    # from statvfs at reconcile time (whole-filesystem accounting)
    budget_bytes: int = 0
    # pressure thresholds as fractions of the budget.  full_frac < 1.0
    # is the RESERVED HEADROOM: admission stops at full_frac so that
    # reclaim's own writes (snapshot temp dirs, journal-compaction tmp
    # files) still fit under the hard budget — otherwise a full store
    # could never compact its way back out (the classic deadlock)
    near_full_frac: float = 0.80
    full_frac: float = 0.92
    # hysteresis (evaluation rounds): worsen fast — usage is monotonic
    # between reclaims, not noisy — recover only once reclaim has
    # PROVEN space back
    worsen_after: int = 1
    recover_after: int = 2
    # rounds the raw level is pinned FULL after an observed ENOSPC,
    # regardless of the usage estimate: the disk itself voted
    enospc_latch_rounds: int = 2


# Fed from EXECUTOR threads (the LogManager flush loop accounts append
# bytes off-loop; snapshot commits run in the executor) as well as the
# store's event loop — cross-thread like DiskLatencyProbe, so it
# carries its own lock.
class DiskBudget:
    """Per-store disk usage estimate -> hysteretic {OK, NEAR_FULL,
    FULL} pressure.

    Hot-path fed like the HealthTracker (the PR 11 lesson: signals the
    hot path already produces, measured where they happen): log-append
    bytes, snapshot commit/prune deltas, journal-compaction reclaim —
    plus a periodic ``reconcile()`` against real directory/statvfs
    usage that re-bases the estimate (rmtree-style deletes and native
    journal GC never report through the hot path)."""

    def __init__(self, opts: DiskBudgetOptions | None = None,
                 label: str = ""):
        self.opts = opts or DiskBudgetOptions()
        self.label = label
        self._lock = threading.Lock()
        self._base = 0             # reconciled usage      guarded-by: _lock
        self._delta = 0            # hot-path bytes since  guarded-by: _lock
        self._capacity = int(self.opts.budget_bytes)  # guarded-by: _lock
        self._enospc_latch = 0     # rounds pinned FULL    guarded-by: _lock
        self._hyst = _Hysteresis(self.opts.worsen_after,
                                 self.opts.recover_after,
                                 levels=_PRESSURE_LEVELS,
                                 initial=PRESSURE_OK)  # guarded-by: _lock
        # observability (all guarded-by: _lock)
        self.evaluations = 0
        self.reconciles = 0
        self.enospc_events = 0
        self.appended_bytes = 0
        self.reclaimed_bytes = 0
        self.full_rounds = 0
        self.near_full_rounds = 0
        self.resumes = 0           # FULL -> better transitions

    # -- signal intake (hot paths, any thread) -------------------------------

    def note_append(self, nbytes: int) -> None:
        """Log bytes flushed to storage (LogManager flush loop)."""
        with self._lock:
            self._delta += nbytes
            self.appended_bytes += nbytes

    def note_snapshot(self, delta_bytes: int) -> None:
        """Snapshot commit (+bytes) or prune/delete (-bytes)."""
        with self._lock:
            self._delta += delta_bytes
            if delta_bytes < 0:
                self.reclaimed_bytes += -delta_bytes

    def note_reclaimed(self, nbytes: int) -> None:
        """Bytes freed by log/journal compaction."""
        with self._lock:
            self._delta -= nbytes
            self.reclaimed_bytes += nbytes

    def note_enospc(self) -> None:
        """The disk itself refused a write: pin raw FULL for the next
        ``enospc_latch_rounds`` evaluations whatever the estimate says
        — the estimate is wrong, the errno is not."""
        with self._lock:
            self.enospc_events += 1
            self._enospc_latch = max(self._enospc_latch,
                                     self.opts.enospc_latch_rounds)

    def set_budget(self, budget_bytes: int) -> None:
        """Operator resize: adopt a new explicit byte ceiling mid-run
        (volume grown/shrunk under the store).  0 switches to the
        reconcile-reported capacity (statvfs mode)."""
        with self._lock:
            self.opts.budget_bytes = int(budget_bytes)
            if budget_bytes > 0:
                self._capacity = int(budget_bytes)

    def reconcile(self, used_bytes: int,
                  capacity_bytes: int | None = None) -> None:
        """Re-base the estimate on measured usage (directory walk or
        statvfs, taken OFF the hot path by the store's health task)."""
        with self._lock:
            self._base = max(0, int(used_bytes))
            self._delta = 0
            if self.opts.budget_bytes <= 0 and capacity_bytes:
                self._capacity = int(capacity_bytes)
            self.reconciles += 1

    # -- scoring -------------------------------------------------------------

    def used_bytes(self) -> int:
        with self._lock:
            return max(0, self._base + self._delta)

    def capacity_bytes(self) -> int:
        with self._lock:
            return self._capacity

    def pressure(self) -> str:
        """Current hysteretic pressure (no new evaluation round)."""
        with self._lock:
            return self._hyst.level

    def evaluate(self) -> str:
        """One pressure round (the store's health task cadence): fold
        the usage estimate — or the ENOSPC latch — through the
        thresholds and the hysteresis; records flight-recorder
        ``disk_pressure`` events on transitions."""
        from tpuraft_torch.util.trace import RECORDER

        with self._lock:
            used = max(0, self._base + self._delta)
            cap = self._capacity
            if self._enospc_latch > 0:
                self._enospc_latch -= 1
                raw = PRESSURE_FULL
            elif cap <= 0:
                raw = PRESSURE_OK
            elif used >= cap * self.opts.full_frac:
                raw = PRESSURE_FULL
            elif used >= cap * self.opts.near_full_frac:
                raw = PRESSURE_NEAR_FULL
            else:
                raw = PRESSURE_OK
            prev = self._hyst.level
            level = self._hyst.fold(raw)
            self.evaluations += 1
            if level == PRESSURE_FULL:
                self.full_rounds += 1
            elif level == PRESSURE_NEAR_FULL:
                self.near_full_rounds += 1
            if prev == PRESSURE_FULL and level != PRESSURE_FULL:
                self.resumes += 1
        if level != prev:
            RECORDER.record("disk_pressure", self.label,
                            level=level, was=prev, used=used, capacity=cap)
            if level == PRESSURE_FULL:
                RECORDER.note_anomaly(
                    "disk_full",
                    f"{self.label or 'store'}: {used}/{cap} bytes "
                    f"(+{self.enospc_events} enospc)")
        return level

    # -- observability -------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return {
                "disk_pressure_level": _PRESSURE_LEVELS[self._hyst.level],
                "disk_used_bytes": max(0, self._base + self._delta),
                "disk_capacity_bytes": self._capacity,
                "disk_enospc_events": self.enospc_events,
                "disk_appended_bytes": self.appended_bytes,
                "disk_reclaimed_bytes": self.reclaimed_bytes,
                "disk_reconciles": self.reconciles,
                "disk_full_rounds": self.full_rounds,
                "disk_near_full_rounds": self.near_full_rounds,
                "disk_pressure_resumes": self.resumes,
            }

    def register_gauges(self, metrics) -> None:
        metrics.gauge("disk.pressure_level",
                      lambda: float(_PRESSURE_LEVELS[self.pressure()]))
        metrics.gauge("disk.used_bytes", lambda: float(self.used_bytes()))
        metrics.gauge("disk.capacity_bytes",
                      lambda: float(self.capacity_bytes()))
        metrics.gauge("disk.enospc_events",
                      lambda: float(self.enospc_events))

    def describe(self) -> str:
        with self._lock:
            used = max(0, self._base + self._delta)
            return (f"DiskBudget<{self._hyst.level} used={used} "
                    f"cap={self._capacity} enospc={self.enospc_events} "
                    f"appended={self.appended_bytes} "
                    f"reclaimed={self.reclaimed_bytes} "
                    f"reconciles={self.reconciles} resumes={self.resumes}>")
