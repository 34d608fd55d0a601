"""Metrics registry: named counters, gauges, and log-bucketed histograms.

Counterpart of ``repro.obs.metrics``, with the same bucket edges,
percentile rule and report text.

The paper's evaluation (§4) is built on per-query wall clock and per-node
communication volume; a serving tier additionally needs p50/p95/p99 gates.
This registry is the runtime home for those numbers — cheap enough to stay
on by default (a counter increment is one int add; a histogram record is
one ``math.log`` plus a dict increment), with no background threads and no
unbounded state (histograms hold one bucket counter per occupied
log-bucket, ~a few hundred entries across twelve orders of magnitude).

Histograms are log-bucketed at ``GROWTH = 2**(1/16)`` per bucket, so any
reported quantile is within ``sqrt(GROWTH) - 1`` ≈ 2.2% relative error of
the true order statistic — tight enough for latency gating, bounded
regardless of the distribution's range.

Every metric is safe to update from multiple threads: a serving tier
records from an asyncio event loop AND its dispatch executor
concurrently, so counter increments and histogram
records are read-modify-write sequences that take a per-metric lock (an
uncontended ``threading.Lock`` costs tens of nanoseconds — still cheap
enough to stay on by default).
"""
from __future__ import annotations

import math
import threading
from typing import Mapping, Optional

GROWTH = 2.0 ** (1.0 / 16.0)
_LOG_G = math.log(GROWTH)


class Counter:
    """Monotonic named count (queries served, cache hits, overflows)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:  # += is a read-modify-write; callers race
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins named value (resident cubes, cache size)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Log-bucketed distribution with p50/p95/p99 snapshots.

    ``record(v)`` files ``v`` under bucket ``floor(log(v)/log(GROWTH))``;
    non-positive values land in a dedicated zero-bucket (quantiles report
    them as 0.0).  A quantile is answered by walking the cumulative bucket
    counts and returning the bucket's geometric midpoint, clamped to the
    observed min/max — the relative error is bounded by ``sqrt(GROWTH)``
    per the class invariant, independent of how many values were recorded.
    """

    __slots__ = ("name", "buckets", "zeros", "count", "total", "vmin",
                 "vmax", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.buckets: dict = {}  # bucket index -> count
        self.zeros = 0           # non-positive values
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    def record(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if v <= 0.0:
                self.zeros += 1
                return
            idx = int(math.floor(math.log(v) / _LOG_G))
            self.buckets[idx] = self.buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (0.5 = median), within the
        bucket relative-error bound; 0.0 for an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)  # 0-indexed order statistic
        if rank < self.zeros:
            return 0.0
        seen = self.zeros
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank < seen:
                mid = math.exp((idx + 0.5) * _LOG_G)  # geometric midpoint
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax  # pragma: no cover — rank < count by construction

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics, one flat namespace.

    Dotted names group related metrics (``driver.tier1``,
    ``exchange.overflow``); :meth:`report` renders them sorted so the
    grouping reads as sections.  Re-registering a name with a different
    metric type is a bug and raises immediately.
    """

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            # get-or-create must be atomic: two threads registering the
            # same counter must share ONE object, or increments vanish
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name)
        if type(m) is not cls:
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, not {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def value(self, name: str, default=0):
        """Counter/gauge value by name (0 when never touched)."""
        m = self._metrics.get(name)
        return default if m is None else m.value

    def snapshot(self) -> Mapping[str, object]:
        """Plain-data view of every metric (JSON-serializable)."""
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}

    def report(self) -> str:
        """Aligned text report — the ``--metrics`` exit dump."""
        lines = ["metric" + " " * 30 + "value"]
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                s = m.snapshot()
                if s["count"] == 0:
                    val = "count=0"
                else:
                    val = (f"count={s['count']} mean={s['mean']:.4g} "
                           f"p50={s['p50']:.4g} p95={s['p95']:.4g} "
                           f"p99={s['p99']:.4g} max={s['max']:.4g}")
            elif isinstance(m, Gauge):
                val = f"{m.value:.6g}"
            else:
                val = str(m.value)
            lines.append(f"{name:<36s} {val}")
        return "\n".join(lines)

    def clear(self) -> None:
        self._metrics.clear()
