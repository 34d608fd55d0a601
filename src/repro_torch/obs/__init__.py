"""Runtime observability: structured traces and a metrics registry.

Counterpart of ``repro.obs`` without EXPLAIN:

  trace    nested spans + Chrome-trace/Perfetto export (``Observer``)
  metrics  named counters/gauges/log-bucketed histograms with p50/p95/p99

One :class:`Observer` object is threaded through the engine (driver,
cube router, lowering) — construct your own to assert on emitted spans,
or read ``driver.obs`` for the default always-on one.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import Observer, Span  # noqa: F401
