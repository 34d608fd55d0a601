"""Shared two-tier measurement protocol.

Counterpart of ``repro.cube.serving``: one implementation of "time Tier 1
vs Tier 2 for a query".  The query is ONE IR object: Tier 1 is the
router's host-side rollup slice (N floored at 10 because a single slice is
microseconds); Tier 2 is the SAME query lowered to a plan over the base
tables — the path ``driver.query()`` takes on a cube miss — warm, over
``repeat`` runs, each timed with the device synchronized before and
after it (and under a process group every rank at that point: every
rank calls ``measure_query`` alike, lockstep, and the tier-2 runs cross
the ranks).

Reported statistics are the TRIMMED MEDIAN (drop the top/bottom ~10% of
repeats when there are enough of them, then take the median — robust to
scheduler noise in both directions, unlike min-of-N which reports a best
case no serving tier sustains) and the p99 tail.  Every repeat is also
recorded into the driver's metrics registry (``serving.tier1_us`` /
``serving.tier2_us`` histograms) so a metrics report carries cross-query
percentiles.
"""
from __future__ import annotations

import time

from repro_torch.cube.build import _sync


def _trimmed_median(samples) -> float:
    """Median after dropping the top/bottom ~10% of samples (one sample
    each end per 10, only when n >= 5 so tiny repeat counts keep every
    run).  The trim makes the reported center insensitive to warmup or
    preemption outliers even at small n."""
    xs = sorted(samples)
    k = len(xs) // 10 if len(xs) >= 10 else (1 if len(xs) >= 5 else 0)
    xs = xs[k:len(xs) - k] if k else xs
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _p99(samples) -> float:
    xs = sorted(samples)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


def measure_query(driver, q, *, repeat: int = 5):
    """Time one cube-covered IR query on both tiers.

    Returns ``{"route", "tier1_s", "tier2_s", "tier1_p99_s",
    "tier2_p99_s", "plan"}``, or None when no rollup covers the query
    (Tier 2 only — nothing to compare).  ``tier1_s``/``tier2_s`` are
    trimmed medians over the repeats; ``*_p99_s`` the observed tails.
    """
    match = driver.router.route_query(q) if driver.router is not None else None
    if match is None:
        return None
    cols = driver.columns()

    def sync():
        _sync(driver.cluster)

    driver.router.answer(match.query, match.route)  # warmup (numpy setup)
    s1 = [_clock(lambda: driver.router.answer(match.query, match.route))
          for _ in range(max(repeat, 10))]

    # Tier 2 is the same query lowered to a plan — exactly what
    # driver.query() would run on a cube miss
    fn = driver.compile_query(q)
    plan_name = f"{q.name or 'ir'} (lowered)"
    fn(cols)  # warmup
    s2 = [_clock(lambda: fn(cols), sync) for _ in range(max(repeat, 3))]

    obs = getattr(driver, "obs", None)
    if obs is not None and obs.metrics is not None:
        h1 = obs.metrics.histogram("serving.tier1_us")
        h2 = obs.metrics.histogram("serving.tier2_us")
        for s in s1:
            h1.record(s * 1e6)
        for s in s2:
            h2.record(s * 1e6)

    return {
        "route": match.route,
        "tier1_s": _trimmed_median(s1),
        "tier2_s": _trimmed_median(s2),
        "tier1_p99_s": _p99(s1),
        "tier2_p99_s": _p99(s2),
        "plan": plan_name,
    }


def _clock(fn, sync=None) -> float:
    """Wall seconds of ``fn()``; with ``sync``, the device is synchronized
    before the clock starts and before it stops."""
    if sync is not None:
        sync()
    t0 = time.perf_counter()
    fn()
    if sync is not None:
        sync()
    return time.perf_counter() - t0
