"""Runtime observability: structured traces, a metrics registry, and
EXPLAIN / EXPLAIN ANALYZE rendering.

Counterpart of ``repro.obs``:

  trace    nested spans + Chrome-trace/Perfetto export (``Observer``)
  metrics  named counters/gauges/log-bucketed histograms with p50/p95/p99
  explain  plan rendering with predicted-vs-observed fields

One :class:`Observer` object is threaded through the engine (driver,
cube router, lowering, exchange layer) — construct your own to assert on
emitted spans, or read ``driver.obs`` for the default always-on one.
"""
from repro_torch.obs.explain import (  # noqa: F401
    ExplainReport,
    SemiJoinInfo,
    attribute_semijoin_bytes,
    fmt_expr,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import Observer, Span  # noqa: F401
