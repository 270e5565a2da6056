"""Metrics: counters, gauges, histograms/timers per node.

Reference parity: Dropwizard ``MetricRegistry`` via ``core:core/NodeMetrics``,
``ThreadPoolMetricSet``, ``DisruptorMetricSet`` (SURVEY.md §6).  Names keep
the reference's dotted style (``replicate-entries``, ``append-logs``...).
Lightweight by design: a disabled registry costs one branch.

Thread-safety: histogram samples arrive from executor threads (storage
flush timing) while the event loop reads percentiles and the metrics
HTTP listener renders snapshots — every read-modify-write here is
locked.  ``prometheus_text`` renders any counters/gauges/histograms
mapping in the Prometheus text exposition format (the live-scrape side
of the observability plane; see StoreEngine.metrics_text).
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import defaultdict
from typing import Callable, Optional


class Histogram:
    """Reservoir-free histogram: keeps a bounded ring of samples.

    The ring replaces OLDEST-first once full (a dedicated write cursor
    — deriving it from the post-increment ``count`` skewed slot 0 on
    the first wrap), and ``percentile`` serves from a cached sort that
    a dirty flag invalidates on update instead of re-sorting the whole
    ring per call.
    """

    __slots__ = ("_samples", "_max", "_next", "_sorted", "_dirty",
                 "_lock", "count", "total")

    def __init__(self, max_samples: int = 4096):
        self._samples: list[float] = []
        self._max = max_samples
        self._next = 0            # guarded-by: _lock — ring write cursor
        self._sorted: list[float] = []  # guarded-by: _lock — cached sort
        self._dirty = False       # guarded-by: _lock
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def update(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            if len(self._samples) >= self._max:
                self._samples[self._next] = value
                self._next = (self._next + 1) % self._max
            else:
                self._samples.append(value)
            self._dirty = True

    def _sorted_locked(self) -> list[float]:
        if self._dirty:
            self._sorted = sorted(self._samples)
            self._dirty = False
        return self._sorted

    def percentile(self, p: float) -> float:
        with self._lock:
            s = self._sorted_locked()
            if not s:
                return 0.0
            # nearest-rank: the smallest sample with at least p% of the
            # population at or below it — p99 of 100 samples is the
            # 99th value, p50 of 4 is the 2nd (int-floor indexing was
            # off by one toward the tail on small populations)
            idx = max(0, min(len(s) - 1,
                             math.ceil(p / 100.0 * len(s)) - 1))
            return s[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            s = self._sorted_locked()
            count, total = self.count, self.total

            def pct(p: float) -> float:
                if not s:
                    return 0.0
                return s[max(0, min(len(s) - 1,
                                    math.ceil(p / 100.0 * len(s)) - 1))]

            return {
                "count": count,
                "mean": total / count if count else 0.0,
                "p50": pct(50),
                "p99": pct(99),
                "max": s[-1] if s else 0.0,
            }


class MetricRegistry:
    """Thread-safe: counter bumps and histogram creation arrive from
    executor threads while loop-side readers snapshot."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.histograms: dict[str, Histogram] = {}
        self.gauges: dict[str, Callable[[], float]] = {}

    def counter(self, name: str, delta: int = 1) -> None:
        if self.enabled:
            with self._lock:
                self.counters[name] += delta

    def histogram(self, name: str) -> Optional[Histogram]:
        if not self.enabled:
            return None
        h = self.histograms.get(name)
        if h is None:
            with self._lock:
                h = self.histograms.get(name)
                if h is None:
                    h = self.histograms[name] = Histogram()
        return h

    def update(self, name: str, value: float) -> None:
        if self.enabled:
            self.histogram(name).update(value)

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        if self.enabled:
            with self._lock:
                self.gauges[name] = fn

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def counters_snapshot(self) -> dict:
        """Locked copy of the counter map — cross-thread readers (the
        metrics HTTP daemon thread) must not iterate the live dict a
        first-seen ``count()`` on the loop can resize mid-scrape."""
        with self._lock:
            return dict(self.counters)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            hists = list(self.histograms.items())
            gauges = list(self.gauges.items())
        return {
            "counters": counters,
            "histograms": {k: h.snapshot() for k, h in hists},
            "gauges": {k: g() for k, g in gauges},
        }


class _Timer:
    """``with metrics.timer("replicate-entries"): ...`` records millis."""

    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg: MetricRegistry, name: str):
        self._reg = reg
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._reg.update(self._name, (time.perf_counter() - self._t0) * 1000.0)
        return False


# ---- Prometheus text exposition --------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str = "tpuraft_") -> str:
    n = _NAME_RE.sub("_", name)
    if not n.startswith(prefix):
        n = prefix + n
    return n


def _prom_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{_NAME_RE.sub("_", k)}="{str(v)}"' for k, v in labels.items())
    return "{" + body + "}"


def prometheus_text(counters: Optional[dict] = None,
                    gauges: Optional[dict] = None,
                    histograms: Optional[dict] = None,
                    labels: Optional[dict] = None) -> str:
    """Render flat metric mappings as Prometheus text format.

    ``counters``/``gauges`` map name -> number; ``histograms`` maps
    name -> a :meth:`Histogram.snapshot` dict (rendered as _count/_sum
    plus p50/p99/max quantile gauges).  ``labels`` (e.g. the store
    endpoint) are attached to every sample.
    """
    out: list[str] = []
    lbl = _prom_labels(labels)
    for name, value in sorted((counters or {}).items()):
        n = _prom_name(name)
        out.append(f"# TYPE {n} counter")
        out.append(f"{n}{lbl} {value}")
    for name, value in sorted((gauges or {}).items()):
        n = _prom_name(name)
        out.append(f"# TYPE {n} gauge")
        out.append(f"{n}{lbl} {value}")
    for name, snap in sorted((histograms or {}).items()):
        n = _prom_name(name)
        out.append(f"# TYPE {n} summary")
        for q, key in (("0.5", "p50"), ("0.99", "p99")):
            qlbl = _prom_labels(dict(labels or {}, quantile=q))
            out.append(f"{n}{qlbl} {snap.get(key, 0.0)}")
        out.append(f"{n}_count{lbl} {snap.get('count', 0)}")
        out.append(f"{n}_sum{lbl} "
                   f"{snap.get('mean', 0.0) * snap.get('count', 0)}")
        out.append(f"{n}_max{lbl} {snap.get('max', 0.0)}")
    return "\n".join(out) + ("\n" if out else "")
