"""Injectable time plane: per-store clocks, seeded clock faults, and
the peer-skew sentinel (ISSUE 18).

Every timing-sensitive consumer in the consensus path (election timers,
leader-lease math, store-lease bookkeeping, engine tick deadlines,
health hysteresis) reads time through a :class:`Clock` handle instead of
calling ``time.monotonic()`` directly.  The default is :data:`SYSTEM` —
two staticmethods bound straight to the C-level ``time`` functions, so
an uninstalled clock costs one attribute load over the raw call (the
``kv_ops_clocked`` bench-gate row holds that at <=2%).  A soak installs
a :class:`ChaosClock` per store and the whole store — timers, leases,
hibernation — experiences drift, forward jumps, and freezes coherently,
exactly like a machine with a broken TSC or a VM pausing under
migration.

Safety story (docs/architecture.md "Lease safety under bounded drift"):
LEASE_BASED reads and store-liveness leases compare durations measured
on TWO different clocks.  ``RaftOptions.clock_drift_bound`` (rho)
shrinks every lease the holder trusts by (1 - rho) and is the bound the
deployment promises; the :class:`ClockSentinel` is the detector for the
promise being BROKEN — it estimates each peer's clock rate from beat
acks and, when the median peer disagrees with the local clock by more
than rho, fails lease checks closed so reads fall back to the SAFE
quorum path (linearizable with no clock trust at all).
"""

from __future__ import annotations

import random
import time
from typing import Optional


class SystemClock:
    """Real time.  ``monotonic``/``wall`` are staticmethods bound to the
    C accelerators — calling through an instance adds one attribute
    lookup over the bare call, which is the whole indirection cost."""

    monotonic = staticmethod(time.monotonic)
    wall = staticmethod(time.time)

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "SystemClock()"


#: module default: what every consumer falls back to when no clock is
#: injected.  A module-level singleton (not per-consumer construction)
#: so identity checks like ``clock is SYSTEM`` stay meaningful in tests.
SYSTEM = SystemClock()


def resolve(clock: Optional[object]):
    """``opts.clock or SYSTEM`` with a home: the one-line idiom every
    constructor uses, kept here so the default has a single owner."""
    return clock if clock is not None else SYSTEM


class ChaosClock:
    """A monotonic+wall clock with injectable rate drift, forward
    jumps, and freezes — the fault model for ISSUE 18's time plane.

    The virtual clock is piecewise-linear over the base clock:
    ``monotonic() = anchor_virt + (base - anchor_real) * rate``.  Every
    mutation (``set_rate``/``jump``/``freeze``/``unfreeze``) re-anchors
    at the current instant, so the virtual timeline is continuous
    (except across ``jump``, which is the point) and NEVER runs
    backwards — a frozen clock holds still, a 1.1x clock runs fast from
    here on.  ``wall()`` mirrors the same virtual timeline offset onto
    the base wall clock, so wall-stamped logs skew coherently.

    Deterministic given the event sequence; the ``rng`` only feeds
    :meth:`chaos_step` (the soak's seeded per-store fault driver).
    """

    def __init__(self, seed: int = 0, base: Optional[object] = None):
        self._base = resolve(base)
        self._anchor_real = self._base.monotonic()
        self._anchor_virt = self._anchor_real
        self._rate = 1.0
        self._rate_before_freeze = 1.0
        self.rng = random.Random(seed)
        # injection counters for soak/run reports
        self.faults: dict[str, int] = {
            "drift": 0, "jump": 0, "freeze": 0, "unfreeze": 0}

    # -- reads ---------------------------------------------------------------

    def monotonic(self) -> float:
        return self._anchor_virt \
            + (self._base.monotonic() - self._anchor_real) * self._rate

    def wall(self) -> float:
        # the wall clock carries the same virtual-vs-real displacement
        return self._base.wall() + (self.monotonic()
                                    - self._base.monotonic())

    # -- fault injection -----------------------------------------------------

    def _rebase(self) -> None:
        now_real = self._base.monotonic()
        self._anchor_virt = self._anchor_virt \
            + (now_real - self._anchor_real) * self._rate
        self._anchor_real = now_real

    def set_rate(self, rate: float) -> None:
        """Run ``rate`` virtual seconds per real second from now on
        (1.1 = 10% fast, 0.9 = 10% slow, 0 = frozen)."""
        if rate < 0.0:
            raise ValueError("a monotonic clock cannot run backwards")
        self._rebase()
        self._rate = rate
        if rate != 1.0:
            self.faults["drift"] += 1

    def jump(self, seconds: float) -> None:
        """Step the clock FORWARD by ``seconds`` instantly (leap
        second, NTP slam, VM resume)."""
        if seconds < 0.0:
            raise ValueError("a monotonic clock cannot jump backwards")
        self._rebase()
        self._anchor_virt += seconds
        self.faults["jump"] += 1

    def freeze(self) -> None:
        """Hold the clock still until :meth:`unfreeze` (stuck counter,
        paused VM)."""
        if self._rate != 0.0:
            self._rate_before_freeze = self._rate
        self.set_rate(0.0)
        self.faults["freeze"] += 1

    def unfreeze(self) -> None:
        self.set_rate(self._rate_before_freeze)
        self.faults["unfreeze"] += 1

    @property
    def rate(self) -> float:
        return self._rate

    @property
    def frozen(self) -> bool:
        return self._rate == 0.0

    def heal(self) -> None:
        """Back to real rate (accumulated offset persists — healing a
        drifted clock does not step it backwards)."""
        self.set_rate(1.0)

    def chaos_step(self) -> str:
        """One seeded fault from the soak menu: drift fast/slow, jump
        forward, or freeze; a frozen clock always unfreezes first so
        faults keep composing.  Returns a description for the log."""
        if self.frozen:
            self.unfreeze()
            return "unfreeze"
        roll = self.rng.random()
        if roll < 0.4:
            rate = self.rng.choice([1.05, 1.1, 1.25, 0.9, 0.8])
            self.set_rate(rate)
            return f"drift rate={rate}"
        if roll < 0.75:
            s = 0.2 + self.rng.random() * 1.3
            self.jump(s)
            return f"jump +{s:.2f}s"
        self.freeze()
        return "freeze"

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return (f"ChaosClock(rate={self._rate}, "
                f"virt={self.monotonic():.3f})")


class ClockSentinel:
    """Peer-skew estimator riding the beat RTT probes (ISSUE 18
    DETECTION).

    Beat acks carry the responder's clock reading (``clock_ms``); the
    hub feeds each (send instant, ack instant, peer reading) triple
    here.  Per peer we track the peer-vs-local clock-RATE ratio over
    successive acks — ``(peer_now - peer_prev) / (local_now -
    local_prev)`` EWMA-smoothed — and the peer-vs-local offset.  All
    arithmetic runs on the LOCAL injected clock: a frozen local clock
    makes every peer look infinitely fast, a 1.1x local clock makes
    every peer look ~0.91x slow, which is exactly the symmetry the
    median vote exploits: when the MEDIAN peer deviates beyond the
    drift bound, the local clock is the suspect (a minority of broken
    peers cannot outvote the majority), and lease checks fail closed.

    ``suspect()`` is the one consumer-facing bit: True means "do not
    trust a lease on this store's clock".  Recovery is automatic — the
    estimate re-converges once the clock heals (EWMA horizon), so a
    transient jump fences reads only for a few beat rounds.
    """

    #: ignore rate samples over windows shorter than this — RTT jitter
    #: swamps the numerator below it
    MIN_WINDOW_S = 0.05
    #: EWMA weight for new rate samples (≈10-sample horizon)
    ALPHA = 0.2
    #: offset step (seconds) flagged as a jump anomaly even when the
    #: rate estimate has not yet crossed the bound
    JUMP_S = 0.25

    def __init__(self, drift_bound: float = 0.0,
                 clock: Optional[object] = None, label: str = ""):
        self._clock = resolve(clock)
        self.drift_bound = drift_bound
        self.label = label
        # peer -> (last local midpoint, last peer reading, rate EWMA)
        self._peers: dict[str, tuple[float, float, Optional[float]]] = {}
        self._offsets: dict[str, float] = {}
        self._suspect = False
        # counters (summed into store describe / soak reports)
        self.samples = 0
        self.anomalies = 0
        self.lease_fenced = 0      # lease checks failed closed by us
        self._last_reason = ""
        # per-peer gauges register lazily as peers first report — the
        # roster is not known at store boot (membership changes)
        self._metrics = None
        self._peer_gauges: set = set()

    # -- intake --------------------------------------------------------------

    def observe(self, peer: str, peer_clock_s: float,
                sent_at: float, acked_at: float) -> None:
        """One beat-ack probe: local send/ack instants (local clock)
        and the peer's clock reading taken while serving the ack."""
        if peer_clock_s <= 0.0:
            return            # peer predates the clock_ms field
        local_mid = (sent_at + acked_at) / 2.0
        prev = self._peers.get(peer)
        self._offsets[peer] = peer_clock_s - local_mid
        self._register_peer_gauge(peer)
        if prev is None:
            self._peers[peer] = (local_mid, peer_clock_s, None)
            return
        prev_mid, prev_peer, ewma = prev
        d_local = local_mid - prev_mid
        d_peer = peer_clock_s - prev_peer
        self.samples += 1
        if d_local < self.MIN_WINDOW_S:
            # local clock barely advanced between acks.  Real cadence
            # puts beats many MIN_WINDOW_S apart, so a near-zero local
            # delta while the peer advanced is the FROZEN-local-clock
            # signature — score it as an extreme ratio instead of
            # discarding it (discarding would blind the sentinel to
            # the one fault rate math cannot see).
            if d_peer > 10.0 * max(d_local, 1e-6):
                ratio = 100.0
            else:
                return
        else:
            ratio = d_peer / d_local
        ewma = ratio if ewma is None \
            else ewma + self.ALPHA * (ratio - ewma)
        self._peers[peer] = (local_mid, peer_clock_s, ewma)
        self._reassess()

    def forget(self, peer: str) -> None:
        self._peers.pop(peer, None)
        self._offsets.pop(peer, None)

    # -- assessment ----------------------------------------------------------

    def _median_ratio(self) -> Optional[float]:
        rates = sorted(e for _, _, e in self._peers.values()
                       if e is not None)
        if not rates:
            return None
        return rates[len(rates) // 2]

    def _reassess(self) -> None:
        if self.drift_bound <= 0.0:
            return            # detection-only deployment: never fence
        med = self._median_ratio()
        if med is None:
            return
        bad = abs(med - 1.0) > self.drift_bound
        if bad and not self._suspect:
            self._suspect = True
            self.anomalies += 1
            self._last_reason = f"median peer clock rate {med:.3f}"
            self._emit("suspect", med)
        elif not bad and self._suspect:
            self._suspect = False
            self._emit("cleared", med)

    def _emit(self, what: str, med: float) -> None:
        from tpuraft_torch.util.trace import RECORDER

        RECORDER.record("clock_anomaly", group=self.label, state=what,
                        median_rate=round(med, 4),
                        bound=self.drift_bound)
        if what == "suspect":
            RECORDER.note_anomaly(
                "clock_anomaly",
                f"{self.label}: local clock suspect — {self._last_reason}"
                f" (bound {self.drift_bound})")

    # -- consumers -----------------------------------------------------------

    def suspect(self) -> bool:
        """True = the LOCAL clock disagrees with the peer median beyond
        the drift bound: lease math must not be trusted."""
        return self._suspect

    def lease_check(self) -> bool:
        """Gate a lease-validity check: False forces the caller onto
        the clock-independent path and counts the fence."""
        if self._suspect:
            self.lease_fenced += 1
            return False
        return True

    def skew_of(self, peer: str) -> Optional[float]:
        """Latest estimated peer-minus-local clock offset (seconds);
        None before the first probe."""
        return self._offsets.get(peer)

    def rate_of(self, peer: str) -> Optional[float]:
        e = self._peers.get(peer)
        return e[2] if e else None

    def peers(self) -> dict[str, dict]:
        out = {}
        for p, (_, _, ewma) in self._peers.items():
            out[p] = {
                "skew_s": round(self._offsets.get(p, 0.0), 4),
                "rate": round(ewma, 4) if ewma is not None else None,
            }
        return out

    def counters(self) -> dict[str, int]:
        return {
            "clock_skew_samples": self.samples,
            "clock_anomalies": self.anomalies,
            "clock_lease_fenced": self.lease_fenced,
            "clock_suspect": int(self._suspect),
        }

    def gauges(self) -> dict[str, float]:
        """Pull-style gauge dict for exposition paths that bypass the
        opt-in KV registry (StoreEngine.metrics_counters, the health /
        disk-budget pattern) — the ``admin.py clocks`` dashboard must
        work against a store that never enabled KV metrics."""
        out = {
            "clock.suspect": float(self._suspect),
            "clock.max_abs_skew_s": max(
                (abs(v) for v in self._offsets.values()), default=0.0),
            "clock.lease_fenced": float(self.lease_fenced),
        }
        for p, off in list(self._offsets.items()):
            out[f"clock.peer_skew_s.{p}"] = off
        return out

    def register_gauges(self, metrics) -> None:
        """Prometheus surface: suspect flag, worst |skew|, fence count,
        plus a per-peer skew gauge as each peer first reports (the
        ``admin.py clocks`` dashboard reads these)."""
        metrics.gauge("clock.suspect", lambda: float(self._suspect))
        metrics.gauge(
            "clock.max_abs_skew_s",
            lambda: max((abs(v) for v in self._offsets.values()),
                        default=0.0))
        metrics.gauge("clock.lease_fenced",
                      lambda: float(self.lease_fenced))
        self._metrics = metrics
        for p in list(self._peers):
            self._register_peer_gauge(p)

    def _register_peer_gauge(self, peer: str) -> None:
        if self._metrics is None or peer in self._peer_gauges:
            return
        self._peer_gauges.add(peer)
        self._metrics.gauge(
            f"clock.peer_skew_s.{peer}",
            lambda p=peer: self._offsets.get(p, 0.0))

    def snapshot(self) -> dict:
        """Structured view (admin RPC / soak report)."""
        med = self._median_ratio()
        return {
            "suspect": self._suspect,
            "drift_bound": self.drift_bound,
            "median_rate": round(med, 4) if med is not None else None,
            "peers": self.peers(),
            **self.counters(),
        }

    def describe(self) -> str:
        med = self._median_ratio()
        peers = ", ".join(
            f"{p}=skew{d['skew_s']:+.3f}s"
            + (f"@x{d['rate']}" if d["rate"] is not None else "")
            for p, d in sorted(self.peers().items())) or "-"
        return (f"ClockSentinel<{self.label or '-'} "
                f"suspect={self._suspect} bound={self.drift_bound} "
                f"median_rate={med if med is None else round(med, 4)} "
                f"samples={self.samples} anomalies={self.anomalies} "
                f"fenced={self.lease_fenced} peers=[{peers}]>")
