"""The port's observability hub against the JAX package's: histogram
percentiles, the metrics report, span nesting and the Chrome trace, and
the counter and span names the driver emits for a tier-1 query, a tier-2
query and a batch.

The registry and the observer are pure Python in both packages, so the
same inputs must give the same snapshots and text.  Span timestamps come
from a shared fake clock.  The driver comparison uses shapes no other
test prepares, so the plan caches of the shared JAX driver start cold
for them; the JAX package's ``xla.trace`` event (one an XLA trace) has no
counterpart, the port's ``lower`` span and ``plan.compile_events``
counter mark its lowerings.
"""
from __future__ import annotations

import itertools
import json
import threading

import numpy as np
import pytest

from repro.obs import Histogram as JHistogram
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Observer as JObserver
from repro.query import C as JC
from repro.query import Param as JParam
from repro.query import Q as JQ
from repro_torch.obs import Histogram, MetricsRegistry, Observer
from repro_torch.query.ir import C, Param, Q
from repro_torch.tpch.driver import TPCHDriver


def _samples(kind):
    rng = np.random.default_rng(11)
    if kind == "uniform":
        return [float(v) for v in range(1, 1001)]
    if kind == "bimodal with zeros":
        return [0.0] * 30 + [1.0] * 50 + [1000.0] * 50 + [-3.0]
    if kind == "lognormal":
        return list(rng.lognormal(3.0, 2.0, 5000))
    return [42.0]


@pytest.mark.parametrize("kind", ["uniform", "bimodal with zeros",
                                  "lognormal", "one value"])
def test_histogram_matches_jax(kind):
    mine, theirs = Histogram("h"), JHistogram("h")
    for v in _samples(kind):
        mine.record(v)
        theirs.record(v)
    assert mine.snapshot() == theirs.snapshot()
    for q in np.linspace(0.0, 1.0, 41):
        assert mine.quantile(q) == theirs.quantile(q)
    assert mine.buckets == theirs.buckets


def _fill(reg):
    reg.counter("driver.tier1").inc()
    reg.counter("driver.tier1").inc(4)
    reg.counter("exchange.overflow")
    reg.gauge("storage.bytes_resident").set(1_404_440_636)
    reg.gauge("router.cubes").set(2)
    for v in (3.0, 7.5, 1200.25, 0.0):
        reg.histogram("query.tier1_us").record(v)
    reg.histogram("query.tier2_us")


def test_registry_report_and_snapshot_match_jax():
    mine, theirs = MetricsRegistry(), JMetricsRegistry()
    _fill(mine)
    _fill(theirs)
    assert mine.report() == theirs.report()
    assert mine.snapshot() == theirs.snapshot()
    assert mine.value("driver.tier1") == 5
    assert mine.value("never.touched") == theirs.value("never.touched") == 0
    with pytest.raises(TypeError, match="is a Counter, not Histogram"):
        mine.histogram("driver.tier1")
    mine.clear()
    assert mine.report() == "metric" + " " * 30 + "value"


def test_counter_increments_from_threads_are_not_lost():
    reg = MetricsRegistry()

    def work():
        for _ in range(2000):
            reg.counter("c").inc()
            reg.histogram("h").record(1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.value("c") == 16000 and reg.histogram("h").count == 16000


def _trace(obs):
    """One nested trace on a fake clock (ticks of 1.5 ms)."""
    ticks = itertools.count()
    obs._now = lambda: next(ticks) * 1.5e-3
    with obs.span("query", source="q1", cache="miss") as sp:
        with obs.span("route", cat="route"):
            obs.event("router.route", cat="route", cube="lineitem_pricing",
                      cells=np.int64(516))
        with obs.span("execute", cat="exec"):
            pass
        sp.set(tier=2, route="q1")
    obs.event("parameterize", cat="plan", extracted=1)
    try:
        with obs.span("query", source="bad"):
            raise ValueError("boom")
    except ValueError:
        pass
    req = obs.open_span("request", cat="serve", lanes=3)
    obs.close_span(req)


def test_spans_and_chrome_trace_match_jax(tmp_path):
    mine, theirs = Observer(), JObserver()
    _trace(mine)
    _trace(theirs)
    assert mine.pretty() == theirs.pretty()
    got, want = mine.to_chrome_trace(), theirs.to_chrome_trace()
    assert got["traceEvents"] == want["traceEvents"]
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    assert [e["ph"] for e in got["traceEvents"]] == [
        "X", "X", "i", "X", "i", "X", "X"]
    assert got["traceEvents"][-2]["args"]["error"] == "ValueError: boom"
    path = mine.save_chrome_trace(str(tmp_path / "trace" / "q.json"))
    with open(path) as f:
        assert json.load(f) == got
    assert [s.name for s in mine.find("route")] == ["route"]
    assert mine.last("router.route").attrs["cube"] == "lineitem_pricing"


def test_disabled_observer_keeps_metrics_and_drops_spans():
    mine = Observer(enabled=False)
    with mine.span("query") as sp:
        sp.set(tier=1)
        mine.event("e")
        mine.metrics.counter("driver.tier1").inc()
    mine.close_span(mine.open_span("request"))
    assert list(mine.spans) == [] and mine.pretty() == ""
    assert mine.metrics.value("driver.tier1") == 1


# -- the driver's counters and spans against the JAX driver's ----------------

def _queries(Qm, Cm, Pm):
    """A tier-1 query, a tier-2 query (a filter on no cube dimension) and
    a parameterized shape for a batch, in one IR."""
    tier1 = (Qm.scan("orders")
             .filter(Cm("o_orderdate") <= 1095)  # 1994-12-31, a month end
             .group_agg(keys=[("orderstatus", Cm("o_orderstatus"), 3)],
                        aggs=[("count_orders", "count"),
                              ("sum_totalprice", "sum",
                               Cm("o_totalprice"))])
             .named("obs_tier1"))
    tier2 = (Qm.scan("lineitem")
             .filter(Cm("l_suppkey") == 7)
             .group_agg(keys=[("linestatus", Cm("l_linestatus"), 2)],
                        aggs=[("sum_qty", "sum", Cm("l_quantity"))])
             .named("obs_tier2"))
    batch = (Qm.scan("lineitem")
             .filter(Cm("l_quantity") < Pm("obs_qty", "float32"))
             .group_agg(aggs=[("revenue", "sum", Cm("l_extendedprice"))])
             .named("obs_batch"))
    return tier1, tier2, batch


def _drive(drv, queries):
    """Run the three queries; returns (tiers, metrics that moved, span and
    event names recorded meanwhile)."""
    drv.obs.clear()
    before = drv.obs.metrics.snapshot()
    tier1, tier2, batch = queries
    tiers = (drv.query(tier1).tier, drv.query(tier2).tier)
    ans = drv.prepare(batch).execute_batch({"obs_qty": [10.0, 30.0]})
    assert ans.value.shape[0] == 2
    after = drv.obs.metrics.snapshot()
    moved = {}
    for name, v in after.items():
        old = before.get(name)
        if isinstance(v, dict):  # a histogram: its count, where it moved
            # (another test on the shared driver may have registered it)
            n = v["count"] - (old or {"count": 0})["count"]
            if n:
                moved[name] = n
        elif v != old:
            moved[name] = v - (old or 0)
    names = set()

    def walk(s):
        names.add(s.name)
        for c in s.children:
            walk(c)

    for s in drv.obs.spans:
        walk(s)
    return tiers, moved, names


def test_driver_metric_and_span_names_match_jax(tpch_driver):
    if not tpch_driver.cubes:
        tpch_driver.build_cubes()
    port = TPCHDriver(0.01, seed=0, device="cpu")
    port.build_cubes()
    tiers, moved, names = _drive(port, _queries(Q, C, Param))
    jtiers, jmoved, jnames = _drive(tpch_driver, _queries(JQ, JC, JParam))
    assert tiers == jtiers == (1, 2)
    assert moved == jmoved
    assert moved["driver.tier1"] == moved["driver.tier2"] == 1
    assert moved["driver.batch"] == 1 and moved["driver.batch_lanes"] == 2
    assert names == jnames - {"xla.trace"}
    assert {"query", "route", "router.route", "lower", "execute",
            "query.batch", "parameterize"} <= names
    # the cube builds' spans and gauge
    port.obs.clear()
    port.build_cubes()
    assert [s.attrs["cube"] for s in port.obs.find("cube.build")] == [
        "lineitem_pricing", "orders_status"]
    assert port.obs.metrics.value("router.cubes") == 2
