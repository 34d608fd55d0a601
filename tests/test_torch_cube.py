"""The port's two-tier query path against the JAX package: cube specs,
binned codes, the default cubes' rollups, the build methods, the router's
decisions, tier-1 and tier-2 answers through ``query`` and ``prepare``,
the bounded one-hot product, the min/max all-reduces and the resident
budget.

Both packages generate the tables in this one process (SF 0.01, seed 0,
8 nodes; the port on the CPU), where their seeding agrees, so their data
is identical.  Against the JAX package's ``build_cube``: sums within rtol
1e-5 (f32 sums in another order), counts, rows, min and max exactly;
answers against the JAX driver and the float64 oracle within rtol 2e-4,
the JAX tests' tolerance.  The kernel method runs B2's plain version
(the tensors lie on the CPU); no Pallas kernel runs here.
"""
from __future__ import annotations

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jaggregation
from repro.cube import CubeSpec as JCubeSpec
from repro.cube import Dimension as JDimension
from repro.cube import Measure as JMeasure
from repro.cube.build import _codes as jax_codes
from repro.cube.build import build_cube as jax_build_cube
from repro.query import C as JC
from repro.query import Q as JQ
from repro.query import UncoveredQueryError as JUncoveredQueryError
from repro.tpch import cubes as jcubes
from repro.tpch import driver as jdriver
from repro.tpch import queries as jq
from repro.tpch import schema as jschema
from repro_torch.core import aggregation, exchange
from repro_torch.cube import CubeSpec, Dimension, Measure, build_cube
from repro_torch.cube.build import ROWS, _codes
from repro_torch.cube.serving import measure_query
from repro_torch.kernels import ops
from repro_torch.query.ir import C, Q, UncoveredQueryError
from repro_torch.tpch import cubes as tcubes
from repro_torch.tpch import queries as tq
from repro_torch.tpch import schema as tschema
from repro_torch.tpch.driver import (
    ResidentBudgetError,
    TPCHDriver,
    _raw_bytes,
)

PORT = types.SimpleNamespace(Q=Q, C=C, q=tq, cubes=tcubes, S=tschema,
                             Dimension=Dimension, Measure=Measure,
                             CubeSpec=CubeSpec)
JAX = types.SimpleNamespace(Q=JQ, C=JC, q=jq, cubes=jcubes, S=jschema,
                            Dimension=JDimension, Measure=JMeasure,
                            CubeSpec=JCubeSpec)
DP = tschema.DEFAULT_PARAMS


@pytest.fixture(scope="module")
def jax_drv(tpch_driver):
    """The shared JAX driver (SF 0.01) with the default cubes built."""
    if not tpch_driver.cubes:
        tpch_driver.build_cubes()
    return tpch_driver


@pytest.fixture(scope="module")
def port_drv():
    d = TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu")
    d.build_cubes()
    return d


def _jax_build(drv, spec):
    return jax_build_cube(drv.cluster, drv.ctx, drv.placed, spec)


def _port_build(drv, spec):
    return build_cube(drv.cluster, drv.ctx, drv.placed, spec)


def _hold_rollups(got, want, sum_rtol=1e-5):
    """Rollup arrays of two cubes: sums within ``sum_rtol``; counts, rows,
    min and max (with the +-inf of empty cells) exactly."""
    assert set(got.rollups) == set(want.rollups)
    for dims, arrays in want.rollups.items():
        assert set(got.rollups[dims]) == set(arrays), dims
        for name, w in arrays.items():
            g = got.rollups[dims][name]
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == np.float32, (dims, name)
            agg = ("count" if name == ROWS else
                   next(m.agg for m in want.spec.measures if m.name == name))
            if agg == "sum":
                np.testing.assert_allclose(g, w, rtol=sum_rtol, atol=0)
            else:
                np.testing.assert_array_equal(g, w)


def test_tables_are_the_jax_tables(jax_drv, port_drv):
    for t in ("lineitem", "orders"):
        for c, col in jax_drv.tables[t].columns.items():
            np.testing.assert_array_equal(port_drv.tables[t].columns[c],
                                          np.asarray(col).reshape(-1))


# -- spec validation ---------------------------------------------------------

def _bad_specs(m):
    dim = m.Dimension("a", "col_a", 4)
    return {
        "unknown agg": lambda: m.CubeSpec(
            "bad", "t", (dim,), (m.Measure("m", "median", "col"),)),
        "sum without a column": lambda: m.CubeSpec(
            "bad", "t", (dim,), (m.Measure("m", "sum"),)),
        "rollup over an unknown dim": lambda: m.CubeSpec(
            "bad", "t", (dim,), (m.Measure("m", "sum", "col"),),
            rollups=(("nope",),)),
        "no cardinality and no edges": lambda: m.Dimension("d", "c"),
        "duplicate dims": lambda: m.CubeSpec(
            "bad", "t", (dim, dim), (m.Measure("m", "sum", "col"),)),
        "duplicate measures": lambda: m.CubeSpec(
            "bad", "t", (dim,), (m.Measure("m", "sum", "col"),
                                 m.Measure("m", "count"))),
        "unknown method": lambda: m.CubeSpec(
            "bad", "t", (dim,), (m.Measure("m", "sum", "col"),),
            method="magic"),
    }


@pytest.mark.parametrize("case", sorted(_bad_specs(PORT)))
def test_spec_validation_raises_where_jax_raises(case):
    with pytest.raises(ValueError) as theirs:
        _bad_specs(JAX)[case]()
    with pytest.raises(ValueError) as mine:
        _bad_specs(PORT)[case]()
    assert str(mine.value) == str(theirs.value)


def test_spec_geometry_matches_jax():
    for mine, theirs in zip(tcubes.default_specs(), jcubes.default_specs()):
        assert mine.rollups == theirs.rollups
        assert mine.shape == theirs.shape and mine.num_cells == theirs.num_cells
        assert mine.resolve_method() == theirs.resolve_method() == "onehot"
        for d, jd in zip(mine.dimensions, theirs.dimensions):
            assert (d.name, d.column, d.cardinality, d.edges, d.integral) == (
                jd.name, jd.column, jd.cardinality, jd.edges, jd.integral)
        for needed in ((), ("shipmonth",), ("orderpriority",),
                       ("returnflag", "linestatus")):
            assert mine.covering_rollups(needed) == \
                theirs.covering_rollups(needed)
    spec = CubeSpec("ok", "t", (Dimension("a", "c", 4),),
                    (Measure("m", "sum", "col"),), rollups=((),))
    assert spec.rollups == (("a",), ())  # the finest is always built
    big = CubeSpec("big", "t", (Dimension("a", "c", 8193),),
                   (Measure("m", "count"),))
    assert big.resolve_method() == "dense"


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_binned_codes_match_jax_at_and_beside_every_edge(dtype):
    edges = tq.month_edges(extra=(DP.q1_shipdate_max,))
    near = sorted({e + d for e in edges for d in (-1, 0, 1)}
                  | {edges[0] - 100, edges[-1] + 100})
    values = np.asarray(near, dtype)
    if dtype == "float32":  # halves beside each edge as well
        values = np.concatenate([values, values + 0.5]).astype(dtype)
    dim = Dimension("m", "x", edges=edges, integral=True)
    jdim = JDimension("m", "x", edges=edges, integral=True)
    got = _codes(dim, {"x": torch.from_numpy(values).reshape(2, -1)})
    want = np.asarray(jax_codes(jdim, {"x": jnp.asarray(values)}))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)
    cat = Dimension("f", "x", 3)
    clipped = _codes(cat, {"x": torch.tensor([[-2, 0, 1, 2, 3, 9]])})
    assert clipped.tolist() == [[0, 0, 1, 2, 2, 2]]


# -- the default cubes against the JAX package's build_cube -----------------

@pytest.mark.parametrize("name", ["lineitem_pricing", "orders_status"])
def test_default_cube_matches_jax_build_cube(jax_drv, port_drv, name):
    got, want = port_drv.cubes[name], jax_drv.cubes[name]
    _hold_rollups(got, want)
    assert got.rows_scanned == want.rows_scanned
    assert got.num_values == want.num_values
    if name == "orders_status":  # empty cells keep their sentinels
        fine = got.rollup(("orderpriority", "orderstatus", "ordermonth"))
        empty = fine[ROWS] == 0
        assert empty.any()
        assert np.all(fine["min_totalprice"][empty] == np.inf)
        assert np.all(fine["max_totalprice"][empty] == -np.inf)


def test_coarser_rollups_are_marginals_of_the_finest(port_drv):
    for cube in port_drv.cubes.values():
        spec = cube.spec
        fine = cube.rollup(spec.dim_names)
        for dims, arrays in cube.rollups.items():
            axes = tuple(i for i, n in enumerate(spec.dim_names)
                         if n not in dims)
            for name, arr in arrays.items():
                agg = ("count" if name == ROWS else
                       next(m.agg for m in spec.measures if m.name == name))
                f = fine[name].astype(np.float64)
                want = (f.min(axis=axes) if agg == "min" else
                        f.max(axis=axes) if agg == "max" else
                        f.sum(axis=axes))
                np.testing.assert_allclose(arr, want, rtol=1e-5)


def _li_dims(m, yearly=False):
    dims = (m.Dimension("returnflag", "l_returnflag", 3),
            m.Dimension("linestatus", "l_linestatus", 2))
    if yearly:
        years = tuple(m.S.day(y, 1, 1) - 1 for y in range(1993, 1999))
        dims += (m.Dimension("shipyear", "l_shipdate", edges=years,
                             integral=True),)
    return dims


def _method_spec(m, kind, method):
    """The specs the build methods are held on: the JAX test's two
    measures over returnflag x linestatus (6 cells, B2's register
    variant), lineitem_pricing's six over a yearly ship bin (48 cells,
    its shared slabs), and orders with min/max (dense only)."""
    if kind == "small":
        return m.CubeSpec(f"li_{method}", "lineitem", _li_dims(m),
                          (m.Measure("sum_qty", "sum", "l_quantity"),
                           m.Measure("count_order", "count")), method=method)
    if kind == "yearly":
        return m.CubeSpec(f"li_yearly_{method}", "lineitem",
                          _li_dims(m, yearly=True),
                          m.cubes.lineitem_cube().measures,
                          rollups=(("returnflag", "linestatus"),),
                          method=method)
    return m.CubeSpec(f"orders_{method}", "orders",
                      (m.Dimension("orderpriority", "o_orderpriority", 5),
                       m.Dimension("orderstatus", "o_orderstatus", 3)),
                      (m.Measure("sum_totalprice", "sum", "o_totalprice"),
                       m.Measure("min_totalprice", "min", "o_totalprice"),
                       m.Measure("max_totalprice", "max", "o_totalprice"),
                       m.Measure("count_orders", "count")),
                      rollups=(("orderstatus",),), method=method)


@pytest.mark.parametrize("method,kind", [("kernel", "small"),
                                         ("kernel", "yearly"),
                                         ("dense", "small"),
                                         ("dense", "orders")])
def test_build_methods_match_onehot_and_jax(jax_drv, port_drv, method, kind):
    onehot = _port_build(port_drv, _method_spec(PORT, kind, "onehot"))
    ops.reset_launch_counts()
    got = _port_build(port_drv, _method_spec(PORT, kind, method))
    # on the CPU the kernel method runs B2's plain version: no launch
    assert ops.launch_counts()["filtered_group_sum"] == 0
    want = _jax_build(jax_drv, _method_spec(JAX, kind, "onehot"))
    _hold_rollups(got, onehot)
    _hold_rollups(got, want)


def test_kernel_method_limits_raise_as_in_jax(jax_drv, port_drv):
    minmax = _method_spec(PORT, "orders", "kernel")
    with pytest.raises(ValueError, match="only sum/count"):
        _port_build(port_drv, minmax)
    with pytest.raises(ValueError, match="only sum/count"):
        _jax_build(jax_drv, _method_spec(JAX, "orders", "kernel"))
    # lineitem_pricing's 516 cells, just past B2's 512 groups
    too_big = CubeSpec("li_big", "lineitem",
                       (Dimension("shipmonth", "l_shipdate",
                                  edges=tq.month_edges(
                                      extra=(DP.q1_shipdate_max,))),
                        Dimension("linestatus", "l_linestatus", 2),
                        Dimension("returnflag", "l_returnflag", 3)),
                       (Measure("count_order", "count"),), method="kernel")
    assert too_big.num_cells > too_big.KERNEL_MAX_GROUPS
    with pytest.raises(ValueError, match="exceeds the kernel limit"):
        _port_build(port_drv, too_big)


# -- router decisions against the JAX router ---------------------------------

def _q1_shaped(m, bound):
    return (m.Q.scan("lineitem")
            .filter(m.C("l_shipdate") <= bound)
            .group_agg(keys=[("returnflag", m.C("l_returnflag"), 3)],
                       aggs=[("sum_qty", "sum", m.C("l_quantity"))]))


ROUTE_CASES = {
    "q1": lambda m: m.q.q1_query(),
    "revenue_by_shipmonth": lambda m: m.q.revenue_by_shipmonth_query(),
    "orders_by_priority": lambda m: m.q.orders_by_priority_query(),
    "non-edge bound": lambda m: m.q.uncovered_query(),
    "below the first edge": lambda m: _q1_shaped(m, m.S.day(1992, 1, 15)),
    "past the last edge": lambda m: _q1_shaped(m, m.S.day(1999, 6, 1)),
    "on a month edge": lambda m: _q1_shaped(m, m.S.day(1995, 7, 1) - 1),
    "uncovered dims": lambda m: (
        m.Q.scan("lineitem").filter(m.C("l_suppkey") == 3)
        .group_agg(keys=[("returnflag", m.C("l_returnflag"), 3)],
                   aggs=[("sum_qty", "sum", m.C("l_quantity"))])),
    "same name, different params": lambda m: m.q.q1_ir(dataclasses.replace(
        m.S.DEFAULT_PARAMS,
        q1_shipdate_max=m.S.DEFAULT_PARAMS.q1_shipdate_max - 10)),
    "stacked shadowing projections": lambda m: (
        m.Q.scan("lineitem").project(x=m.C("l_quantity"))
        .project(x=m.C("x") * 2.0)
        .group_agg(keys=[("returnflag", m.C("l_returnflag"), 3)],
                   aggs=[("sum_x", "sum", m.C("x"))])),
    "projection shadowing its input": lambda m: (
        m.Q.scan("lineitem")
        .project(l_quantity=m.C("l_quantity") * 0.0 + 50.0)
        .group_agg(keys=[("returnflag", m.C("l_returnflag"), 3)],
                   aggs=[("sum_qty", "sum", m.C("l_quantity"))])),
    "a projection the cube can inline": lambda m: (
        m.Q.scan("lineitem").project(q=m.C("l_quantity"))
        .group_agg(keys=[("linestatus", m.C("l_linestatus"), 2)],
                   aggs=[("sum_qty", "sum", m.C("q"))])),
    "min/max in a window": lambda m: (
        m.Q.scan("orders")
        .filter((m.C("o_orderdate") >= m.S.DEFAULT_PARAMS.q4_date_min)
                & (m.C("o_orderdate") < m.S.DEFAULT_PARAMS.q4_date_max))
        .group_agg(keys=[("orderstatus", m.C("o_orderstatus"), 3)],
                   aggs=[("min_totalprice", "min", m.C("o_totalprice")),
                         ("max_totalprice", "max", m.C("o_totalprice"))])),
    "strict bound on a float column": lambda m: (
        m.Q.scan("orders").filter(m.C("o_totalprice") < 1000.0)
        .group_agg(aggs=[("count_orders", "count")])),
}


def _decision(match):
    if match is None:
        return None
    return (match.route.cube.spec.name, match.route.rollup,
            match.query.group_by, match.query.measures,
            tuple((f.dim, f.op, f.value) for f in match.query.filters))


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_router_decision_matches_jax(jax_drv, port_drv, case):
    mine = port_drv.router.route_query(ROUTE_CASES[case](PORT))
    theirs = jax_drv.router.route_query(ROUTE_CASES[case](JAX))
    assert _decision(mine) == _decision(theirs)


# -- answers from query() against the JAX driver and the oracle -------------

ANSWER_CASES = ("q1", "revenue_by_shipmonth", "orders_by_priority",
                "non-edge bound", "on a month edge", "uncovered dims",
                "min/max in a window")


def _numpy_answer(tables, case):
    """Float64 numpy group-by of the case's query over the host tables."""
    li, o = tables["lineitem"].columns, tables["orders"].columns
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    if case in ("q1", "non-edge bound"):
        return None  # the q1 oracle / the JAX driver hold these
    if case == "revenue_by_shipmonth":
        code = np.searchsorted(np.asarray(tq.month_edges(
            extra=(DP.q1_shipdate_max,))), li["l_shipdate"], side="left")
        rev = f64(li["l_extendedprice"]) * (1.0 - f64(li["l_discount"]))
        return np.stack([np.bincount(code, rev, 86),
                         np.bincount(code, minlength=86)], axis=1)
    if case in ("on a month edge", "uncovered dims"):
        sel = (li["l_shipdate"] <= tschema.day(1995, 7, 1) - 1
               if case == "on a month edge" else li["l_suppkey"] == 3)
        return np.bincount(li["l_returnflag"][sel],
                           f64(li["l_quantity"][sel]), 3)[:, None]
    window = ((o["o_orderdate"] >= DP.q4_date_min)
              & (o["o_orderdate"] < DP.q4_date_max))
    if case == "orders_by_priority":
        p = o["o_orderpriority"][window]
        return np.stack([np.bincount(p, minlength=5),
                         np.bincount(p, f64(o["o_totalprice"][window]), 5)],
                        axis=1)
    tp, st = f64(o["o_totalprice"][window]), o["o_orderstatus"][window]
    return np.asarray([[tp[st == s].min(), tp[st == s].max()]
                       for s in range(3)])


@pytest.mark.parametrize("case", ANSWER_CASES)
def test_query_answer_matches_jax_and_numpy(jax_drv, port_drv, case):
    mine = port_drv.query(ROUTE_CASES[case](PORT))
    theirs = jax_drv.query(ROUTE_CASES[case](JAX))
    assert (mine.tier, mine.source) == (theirs.tier, theirs.source)
    assert mine.overflow is False
    got = np.asarray(mine.value, np.float64)
    want = np.asarray(theirs.value, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4)
    if mine.tier == 1:
        assert isinstance(mine.value, np.ndarray)
    if case == "q1":
        np.testing.assert_allclose(got.reshape(6, 6), port_drv.oracle("q1"),
                                   rtol=2e-4)
    ref = _numpy_answer(port_drv.tables, case)
    if ref is not None:
        np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=2e-4)


def test_answers_take_the_expected_tiers(port_drv):
    tiers = {case: port_drv.query(ROUTE_CASES[case](PORT)).tier
             for case in ANSWER_CASES}
    assert tiers == {"q1": 1, "revenue_by_shipmonth": 1,
                     "orders_by_priority": 1, "non-edge bound": 2,
                     "on a month edge": 1, "uncovered dims": 2,
                     "min/max in a window": 1}
    ans = port_drv.query("q15")  # a hand plan by name
    assert (ans.tier, ans.source) == (2, "q15")


@pytest.fixture(scope="module")
def q1_prepared(port_drv):
    return port_drv.prepare(tq.q1_param_ir())


Q1_BINDINGS = {"on-edge": DP.q1_shipdate_max,
               "off-edge": DP.q1_shipdate_max - 1,
               "out-of-range": tschema.day(1999, 6, 1)}


@pytest.mark.parametrize("which", sorted(Q1_BINDINGS))
def test_prepared_q1_param_switches_tier_by_binding(jax_drv, port_drv,
                                                    q1_prepared, which):
    b = {"q1_shipdate_max": Q1_BINDINGS[which]}
    ans = q1_prepared.execute(b)
    theirs = jax_drv.prepare(jq.q1_param_ir()).execute(b)
    assert ans.tier == theirs.tier == (1 if which == "on-edge" else 2)
    assert ans.source == ("lineitem_pricing" if ans.tier == 1 else "q1_param")
    got = np.asarray(ans.value, np.float64).reshape(6, 6)
    np.testing.assert_allclose(
        got, np.asarray(theirs.value, np.float64).reshape(6, 6), rtol=2e-4)
    want = port_drv.oracle("q1", p=tq.oracle_params("q1", b))
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_uncovered_unlowerable_raises_typed_error(jax_drv, port_drv):
    def q(m):
        return (m.Q.scan("orders")
                .filter(m.C("o_orderdate") <= m.S.DEFAULT_PARAMS.q4_date_min
                        + 7)  # not a bin edge
                .group_agg(keys=[("orderstatus", m.C("o_orderstatus"), 3)],
                           aggs=[("min_totalprice", "min",
                                  m.C("o_totalprice"))]))

    with pytest.raises(JUncoveredQueryError):
        jax_drv.query(q(JAX))
    with pytest.raises(UncoveredQueryError, match="no lowerable Tier-2"):
        port_drv.query(q(PORT))


def test_measure_query_times_both_tiers(port_drv):
    obs = port_drv.obs
    h1 = obs.metrics.histogram("serving.tier1_us").count
    out = measure_query(port_drv, tq.orders_by_priority_query(), repeat=3)
    assert out["route"].cube.spec.name == "orders_status"
    assert out["tier1_s"] > 0 and out["tier2_s"] > 0
    assert out["tier1_p99_s"] >= out["tier1_s"]
    assert obs.metrics.histogram("serving.tier1_us").count == h1 + 10
    assert measure_query(port_drv, ROUTE_CASES["uncovered dims"](PORT)) is None


# -- the bounded one-hot product ----------------------------------------------

@pytest.mark.parametrize("shape,masked,cap", [((3, 1000), False, "bytes"),
                                             ((3, 1001, 4), True, "bytes"),
                                             ((3, 1001, 4), False, "rows")])
def test_onehot_in_chunks_equals_one_product_and_jax(monkeypatch, shape,
                                                     masked, cap):
    rng = np.random.default_rng(5)
    P, n = shape[:2]
    G = 7
    values = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(-1, G + 1, (P, n)).astype(np.int32)  # some outside
    mask = rng.random((P, n)) < 0.7 if masked else None
    args = (torch.from_numpy(values), torch.from_numpy(ids), G)
    kw = {"mask": torch.from_numpy(mask)} if masked else {}
    whole = aggregation.group_sum_onehot(*args, **kw)
    calls = []
    matmul = torch.matmul

    def counted(*a):
        calls.append(a[0].shape)
        return matmul(*a)

    monkeypatch.setattr(torch, "matmul", counted)
    if cap == "bytes":  # chunks of 10 rows: P * G * 10 * 4 bytes each
        monkeypatch.setattr(aggregation, "ONEHOT_MAX_BYTES", 4 * P * G * 10)
        rows = 10
    else:  # past the byte limit, chunks of at most ONEHOT_CHUNK_ROWS
        monkeypatch.setattr(aggregation, "ONEHOT_MAX_BYTES", 4 * P * G * 500)
        monkeypatch.setattr(aggregation, "ONEHOT_CHUNK_ROWS", 64)
        rows = 64
    chunked = aggregation.group_sum_onehot(*args, **kw)
    assert len(calls) == -(-n // rows)
    assert all(c[-1] <= rows for c in calls)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    for p in range(P):
        want = jaggregation.group_sum_onehot(
            jnp.asarray(values[p]), jnp.asarray(ids[p]), G,
            None if mask is None else jnp.asarray(mask[p]))
        np.testing.assert_allclose(chunked[p].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_onehot_below_the_limit_is_one_product(monkeypatch):
    calls = []
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda *a: calls.append(a[0].shape) or matmul(*a))
    monkeypatch.setattr(aggregation, "ONEHOT_CHUNK_ROWS", 4)
    ids = torch.randint(0, 6, (8, 5000), dtype=torch.int32)
    out = aggregation.group_sum_onehot(torch.ones(8, 5000), ids, 6)
    assert calls == [(8, 6, 5000)]
    assert out.sum().item() == 8 * 5000


def test_min_max_allreduce_over_the_node_axis():
    x = torch.tensor([[1.0, torch.inf, 5.0], [3.0, torch.inf, -2.0]])
    assert exchange.allreduce_min(x).tolist() == [1.0, float("inf"), -2.0]
    y = torch.tensor([[1.0, -torch.inf], [-7.0, -torch.inf]])
    assert exchange.allreduce_max(y).tolist() == [1.0, float("-inf")]


# -- the resident budget ------------------------------------------------------

@pytest.mark.parametrize("how", ["argument", "environment"])
def test_resident_budget(jax_drv, port_drv, monkeypatch, how):
    packed = port_drv.resident_bytes
    raw = sum(_raw_bytes(t) for t in port_drv.resident.values())
    assert packed == jax_drv.resident_bytes
    assert raw == sum(jdriver._raw_bytes(t)
                      for t in jax_drv.resident.values())
    assert packed < raw
    budget = (packed + raw) // 2
    kw = {}
    if how == "argument":
        kw["resident_budget"] = budget
    else:
        monkeypatch.setenv("REPRO_RESIDENT_BUDGET_BYTES", str(budget))
    with pytest.raises(ResidentBudgetError) as err:
        TPCHDriver(0.01, seed=0, device="cpu", storage="raw", **kw)
    assert f"node budget is {budget} bytes" in str(err.value)
    assert f"fully decoded it would be {raw}" in str(err.value)
    d = TPCHDriver(0.01, seed=0, device="cpu", **kw)
    m = d.obs.metrics
    assert m.value("storage.bytes_resident") == packed
    assert m.value("storage.bytes_resident.lineitem") == \
        jax_drv.obs.metrics.value("storage.bytes_resident.lineitem")
