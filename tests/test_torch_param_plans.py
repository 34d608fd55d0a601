"""Prepared statements in the port against the JAX package: ``parameterize``
(shape and binding), ``TPCHDriver.prepare`` / ``execute`` /
``execute_batch`` over the PARAM_QUERIES q1, q6 and q14_promo, the
batched lowering (lane masks, the mask product, per-lane overflow), the
shape-keyed caches, typed errors, the float-literal meaning of
``query()``, and B1's plain version with lanes of bounds.

Both packages generate the tables in this one process (SF 0.01, seed 0,
8 nodes; the port on the CPU), where their ``hash(table)`` seeding
agrees, so their data is identical.  Against the JAX prepared plan:
counts and flags exactly, f32 values within rtol 1e-5 (sums in another
order); against the float64 oracle: rtol 2e-4 (q14_promo also atol
1e-2), the JAX tests' tolerances.  The JAX answers come from its
compiled prepared plan (tier 2), whatever cubes other tests built on
the shared JAX driver.
"""
from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.query import C as JC
from repro.query import Q as JQ
from repro.query import parameterize as jax_parameterize
from repro.query import query_params as jax_query_params
from repro.query import stats as jstats
from repro.query.ir import Bin as JBin
from repro.query.ir import eval_expr as jax_eval_expr
from repro.tpch import queries as jq
from repro_torch.core import compression
from repro_torch.core.engine import Cluster
from repro_torch.kernels import ops, ref
from repro_torch.query import stats
from repro_torch.query.ir import (
    Bin,
    C,
    GroupAgg,
    IRValidationError,
    Param,
    Q,
    QueryError,
    UnboundParamError,
    eval_expr,
    query_params,
)
from repro_torch.query.lower import (
    ONEHOT_MAX_GROUPS,
    _maskgemm_eligible,
    lower,
)
from repro_torch.query.params import bind_params, parameterize
from repro_torch.tpch import queries as tq
from repro_torch.tpch.driver import TPCHDriver
from repro_torch.tpch.schema import DEFAULT_PARAMS as DP
from repro_torch.tpch.schema import day

NAMES = ["q1", "q6", "q14_promo"]


@pytest.fixture(scope="module")
def port_driver():
    return TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu")


def _oracle(driver, name, binding):
    p = tq.oracle_params(name, binding)
    if name == "q14_promo":
        return driver.oracle("q14", p=p)[1]
    return driver.oracle(name, p=p)


def _check_oracle(name, value, want):
    got = np.asarray(value, np.float64).reshape(np.shape(want))
    atol = 1e-2 if name == "q14_promo" else 0.0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol)


def _bindings(name, seed, n):
    rng = np.random.default_rng(seed)
    return [tq.default_binding(name)] + [tq.random_binding(name, rng)
                                         for _ in range(n)]


# -- parameterize: the reference's shapes and bindings ----------------------

DRIFT = {**{f"ir:{k}": (tq.IR_QUERIES[k], jq.IR_QUERIES[k])
            for k in tq.IR_QUERIES},
         "q4_sj": (tq.q4_sj_ir(), jq.q4_sj_ir()),
         "q18_sj": (tq.q18_sj_ir(), jq.q18_sj_ir()),
         **{f"param:{k}": (tq.PARAM_QUERIES[k](), jq.PARAM_QUERIES[k]())
            for k in tq.PARAM_QUERIES}}


@pytest.mark.parametrize("name", sorted(DRIFT))
def test_parameterize_matches_reference(name):
    mine, theirs = DRIFT[name]
    shape, binding = parameterize(mine)
    jshape, jbinding = jax_parameterize(theirs)
    assert repr(shape.root) == repr(jshape.root)
    assert shape.name == jshape.name
    assert binding == jbinding
    assert ([(p.name, p.dtype, p.lo, p.hi) for p in query_params(shape)]
            == [(p.name, p.dtype, p.lo, p.hi)
                for p in jax_query_params(jshape.root)])
    # bind_params inverts parameterize
    assert repr(bind_params(shape, binding).root) == repr(mine.root)


# -- prepared execution against the JAX prepared plan and the oracle -------


def _jax_tier2(driver, q, binding):
    """The JAX driver's compiled prepared plan at ``binding`` (tier 2)."""
    prep = driver.prepare(q)
    fn = driver._ensure_compiled(prep.entry)
    cols = {n: t.columns for n, t in driver.placed.items()}
    return jax.device_get(fn(cols, prep._cast(prep.binding(binding))))


@pytest.mark.parametrize("name", NAMES)
def test_prepared_matches_jax_and_oracle(tpch_driver, port_driver, name):
    prep = port_driver.prepare(tq.PARAM_QUERIES[name]())
    before = list(port_driver.compile_events)
    for b in _bindings(name, 7, 3):
        ans = prep.execute(b)
        want = _jax_tier2(tpch_driver, jq.PARAM_QUERIES[name](), b)
        assert ans.overflow is False
        assert not bool(np.asarray(want.get("overflow", False)))
        got = ans.value.numpy()
        assert got.dtype == np.float32 and got.shape == want["value"].shape
        np.testing.assert_allclose(got, want["value"], rtol=1e-5)
        _check_oracle(name, got, _oracle(port_driver, name, b))
    # one lowering serves every binding
    new = port_driver.compile_events[len(before):]
    assert new == ([] if prep.query.name in before else [prep.query.name])


@pytest.mark.parametrize("name", NAMES)
def test_prepared_bitwise_equals_literal_plan(port_driver, name):
    """A prepared execute is byte-equal to the port's literal plan of
    ``bind_params(shape, binding)``: parameterization changes no
    arithmetic."""
    d = port_driver
    prep = d.prepare(tq.PARAM_QUERIES[name]())
    b = prep.binding(tq.random_binding(name, np.random.default_rng(23)))
    fn = d._ensure_compiled(prep.entry)
    out_p = fn(d.columns(), prep._cast(b))
    literal = bind_params(prep.query, b)
    assert not query_params(literal.root)
    out_l = d.cluster.compile(lower(literal, d.catalog, wire=d.wire,
                                    binding=b), d.ctx)(d.columns())
    assert set(out_p) == set(out_l)
    for k in out_p:
        assert out_p[k].numpy().tobytes() == out_l[k].numpy().tobytes(), k


# -- batched execution -------------------------------------------------------


@pytest.mark.parametrize("name", ["q6", "q14_promo"])
def test_batch_lanes_bitwise_equal_scalar_executes(port_driver, name,
                                                   monkeypatch):
    prep = port_driver.prepare(tq.PARAM_QUERIES[name]())
    bindings = _bindings(name, 31, 5)[1:]
    scans = []
    monkeypatch.setattr(ops, "scan_filter",
                        lambda *a, _f=ops.scan_filter, **k:
                        scans.append(a[1]) or _f(*a, **k))
    ans = prep.execute_batch(bindings)
    # each packed scan ran once, for every lane
    n_scan = sum(d.mode == "packed" for d in
                 port_driver._ensure_batched(prep.entry).plan.scans)
    assert len(scans) == n_scan and all(lo.shape == (5,) for lo in scans)
    assert ans.value.shape[0] == 5 and ans.overflow.shape == (5,)
    assert not bool(ans.overflow.any())
    for i, b in enumerate(bindings):
        scalar = prep.execute(b)
        assert ans.value[i].numpy().tobytes() == \
            scalar.value.numpy().tobytes()
    padded = prep.execute_batch(bindings[:3], pad_to=4)
    assert torch.equal(padded.value, ans.value[:3])
    assert padded.overflow.shape == (3,)


def test_batched_q1_lanes_match_oracle(port_driver, monkeypatch):
    """The batched q1 contracts the lane masks against the one-hot (x)
    measures in one batched product; every lane equals the oracle."""
    products = []
    monkeypatch.setattr(torch, "bmm", lambda a, b, _f=torch.bmm:
                        products.append(a.shape) or _f(a, b))
    prep = port_driver.prepare(tq.q1_param_ir())
    bindings = _bindings("q1", 41, 4)[1:]
    ans = prep.execute_batch(bindings)
    assert products == [(8, 4, products[0][2])]      # (P, B, n)
    for i, b in enumerate(bindings):
        _check_oracle("q1", ans.value[i].numpy(),
                      _oracle(port_driver, "q1", b))


def test_maskgemm_eligibility_guards():
    def root_of(q):
        assert isinstance(q.root, GroupAgg)
        return q.root

    assert _maskgemm_eligible(root_of(tq.q1_param_ir()), 6)
    big = Q.scan("lineitem").group_agg(
        keys=[("k", C("l_orderkey"), ONEHOT_MAX_GROUPS + 1)],
        aggs=[("n", "count")])
    assert not _maskgemm_eligible(root_of(big), ONEHOT_MAX_GROUPS + 1)
    div = Q.scan("lineitem").group_agg(
        keys=[("returnflag", C("l_returnflag"), 3)],
        aggs=[("r", "sum", C("l_quantity") / C("l_extendedprice"))])
    assert not _maskgemm_eligible(root_of(div), 3)
    param_measure = Q.scan("lineitem").group_agg(
        keys=[("returnflag", C("l_returnflag"), 3)],
        aggs=[("s", "sum", C("l_quantity") * Param("w", "float32"))])
    assert not _maskgemm_eligible(root_of(param_measure), 3)
    projected = (Q.scan("lineitem")
                 .project(x=C("l_quantity") / (C("l_tax") + 1.0))
                 .group_agg(keys=[("returnflag", C("l_returnflag"), 3)],
                            aggs=[("s", "sum", C("x"))]))
    assert not _maskgemm_eligible(root_of(projected), 3)


def test_batched_division_measure_stays_finite(port_driver):
    """A measure that divides can be non-finite on rows the filter drops:
    the batched lowering must not take the mask product there (0 * inf is
    NaN); the lanes match a numpy sum over the kept rows."""
    q = (Q.scan("lineitem")
         .filter(C("l_shipdate") > Param("cut", "int32"))
         .group_agg(keys=[("returnflag", C("l_returnflag"), 3)],
                    aggs=[("ratio_sum", "sum",
                           C("l_quantity") / (C("l_shipdate") - 100.0))]))
    cuts = [150, 400, 800, 1200, 1600, 2000, 2200, 2400]
    got = port_driver.prepare(q).execute_batch(
        [{"cut": c} for c in cuts]).value.numpy()
    assert np.isfinite(got).all()
    li = port_driver.tables["lineitem"].columns
    ship = li["l_shipdate"].astype(np.float64)
    assert (ship == 100).any(), "needs a zero denominator on a dropped row"
    for i, c in enumerate(cuts):
        sel = ship > c
        want = np.zeros(3)
        np.add.at(want, li["l_returnflag"][sel],
                  li["l_quantity"][sel].astype(np.float64)
                  / (ship[sel] - 100.0))
        np.testing.assert_allclose(got[i].reshape(3), want, rtol=2e-4)


def test_batch_overflow_lane_does_not_poison_siblings():
    """The q14 request exchange at a tiny capacity: the one-month lane
    fits, the five-year lane overflows; flags come back per lane and the
    narrow lane still equals the oracle."""
    d = TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu",
                   capacities={"q14_promo_param_request_sj0": 64})
    prep = d.prepare(tq.q14_promo_param_ir(alt="request"))
    narrow = tq.default_binding("q14_promo")
    wide = {"q14_date_min": day(1993, 1, 1), "q14_date_max": day(1998, 1, 1)}
    ans = prep.execute_batch([narrow, wide])
    assert ans.overflow.tolist() == [False, True]
    _check_oracle("q14_promo", ans.value[0].numpy(),
                  _oracle(d, "q14_promo", narrow))
    assert prep.execute(narrow).overflow is False
    assert prep.execute(wide).overflow is True


# -- caches and errors ------------------------------------------------------


def test_plan_cache_keys_on_shape(port_driver):
    d = port_driver
    shifted = dataclasses.replace(DP, q6_quantity=30.0,
                                  q6_date_min=day(1995, 1, 1))
    p1, p2 = d.prepare(tq.q6_ir()), d.prepare(tq.q6_ir(shifted))
    assert p1.entry is p2.entry and p2.cache_hit
    assert p1.defaults != p2.defaults
    assert d.compile_query(tq.q6_ir()) is d.compile_query(tq.q6_ir())
    # a structural change misses: an extra conjunct, another measure
    extra = (Q.scan("lineitem")
             .filter((C("l_shipdate") >= DP.q6_date_min)
                     & (C("l_shipdate") < DP.q6_date_max)
                     & (C("l_discount") >= DP.q6_disc_min)
                     & (C("l_discount") <= DP.q6_disc_max)
                     & (C("l_quantity") < DP.q6_quantity)
                     & (C("l_tax") >= 0.0))
             .group_agg(aggs=[("revenue", "sum",
                               C("l_extendedprice") * C("l_discount"))]))
    other = tq.q6_ir().root
    other = dataclasses.replace(
        other, aggs=(dataclasses.replace(other.aggs[0],
                                         expr=C("l_extendedprice")),))
    assert d.prepare(extra).entry is not p1.entry
    assert d.prepare(dataclasses.replace(tq.q6_ir(), root=other)
                     ).entry is not p1.entry
    # a wire of its own is a plan of its own
    assert d.prepare(tq.q6_ir(), wire="raw").entry is not p1.entry


def _q6_variant(extra_cols):
    cond = ((C("l_shipdate") >= DP.q6_date_min)
            & (C("l_shipdate") < DP.q6_date_max))
    for col in extra_cols:
        cond = cond & (C(col) >= 0.0)
    return (Q.scan("lineitem").filter(cond)
            .group_agg(aggs=[("revenue", "sum", C("l_extendedprice"))]))


def test_caches_evict_the_least_recently_used():
    d = TPCHDriver(0.002, num_nodes=8, seed=0, device="cpu")
    d.IR_CACHE_MAX = 4
    cols = ["l_tax", "l_quantity", "l_discount", "l_extendedprice",
            "l_shipdate", "l_orderkey"]
    shapes = [_q6_variant(cols[:k]) for k in range(6)]
    preps = [d.prepare(s) for s in shapes[:5]]        # the 5th evicts #0
    assert len(d._prepared) == 4
    again0 = d.prepare(shapes[0])                     # gone: a miss
    assert not again0.cache_hit and again0.entry is not preps[0].entry
    hit = d.prepare(shapes[4])                        # the newest: a hit
    assert hit.cache_hit and hit.entry is preps[4].entry
    d.prepare(shapes[5])   # evicts #2: #1 went for again0, #4 was touched
    assert d.prepare(shapes[3]).entry is preps[3].entry
    assert d.prepare(shapes[2]).entry is not preps[2].entry

    d.BOUND_CACHE_MAX = 3

    def fn_for(q):
        return d.compile_query(
            tq.q6_ir(dataclasses.replace(DP, q6_quantity=float(q))))

    fns = [fn_for(q) for q in (20, 21, 22, 23)]       # the 4th evicts 20
    assert len(d.prepare(tq.q6_ir()).entry.bound) == 3
    assert fn_for(23) is fns[3]
    assert fn_for(20) is not fns[0]
    assert fn_for(21) is not fns[1]   # 20's rebuild evicted 21
    # every closure shares the one lowering
    assert d.compile_events.count("q6") == 1


def test_threads_preparing_one_shape_share_one_entry():
    d = TPCHDriver(0.002, num_nodes=8, seed=0, device="cpu")
    entries, barrier = [], threading.Barrier(4)

    def work():
        barrier.wait()
        prep = d.prepare(tq.q6_param_ir())
        d._ensure_compiled(prep.entry)
        entries.append(prep.entry)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(entries) == 4 and all(e is entries[0] for e in entries)
    assert d.compile_events == ["q6_param"]


def test_typed_errors(port_driver):
    prep = port_driver.prepare(tq.q6_param_ir())
    with pytest.raises(UnboundParamError, match="q6_date_min"):
        prep.execute({"q6_date_max": DP.q6_date_max})
    with pytest.raises(UnboundParamError, match="q6_typo"):
        prep.execute({**tq.default_binding("q6"), "q6_typo": 1})
    with pytest.raises(UnboundParamError, match="q6_date_min"):
        prep.execute({**tq.default_binding("q6"), "q6_date_min": "soon"})
    conflicting = (Q.scan("lineitem")
                   .filter((C("l_shipdate") >= Param("p", "int32"))
                           & (C("l_quantity") < Param("p", "float32")))
                   .group_agg(aggs=[("n", "count")]))
    with pytest.raises(IRValidationError, match="declared twice"):
        query_params(conflicting.root)
    with pytest.raises(QueryError, match="no parameters"):
        port_driver.prepare(tq.IR_QUERIES["q1_kernel"]).execute_batch([{}])
    plan = lower(tq.IR_QUERIES["q6"], port_driver.catalog)
    with pytest.raises(ValueError, match="batch"):
        Cluster(8, device="cpu").compile(plan, port_driver.ctx, batch=True)


def test_query_float_literal_compares_in_float32(tpch_driver, port_driver):
    """``query()`` parameterizes a float literal as float32, as the
    reference's ``query()`` does: ``l_discount != 0.05`` drops the rows
    equal to float32(0.05).  ``lower()`` of the literal tree compares in
    float64 and keeps every row."""
    def build(q, c):
        return (q.scan("lineitem").filter(c("l_discount") != 0.05)
                .group_agg(aggs=[("n", "count")]).named("ne"))

    got = float(port_driver.query(build(Q, C)).value)
    _, binding = jax_parameterize(build(JQ, JC))
    want = float(np.asarray(_jax_tier2(tpch_driver, build(JQ, JC),
                                       binding)["value"]).reshape(()))
    rows = port_driver.tables["lineitem"].num_rows
    disc = port_driver.tables["lineitem"].columns["l_discount"]
    assert got == want == rows - int((disc == np.float32(0.05)).sum())
    literal = port_driver.cluster.compile(
        lower(build(Q, C), port_driver.catalog), port_driver.ctx)
    assert float(literal(port_driver.columns())["value"]) == rows > got


# -- bounds, bins and B1's lanes --------------------------------------------


def test_tensor_bounds_match_reference_and_literal_path():
    """Bounds from a tensor equal the reference's traced bounds for every
    value inside a parameter's declared range, and the literal path's for
    any value: outside int32 they clamp (the reference's traced bounds
    wrap there)."""
    values = (0.0, 0.01, 0.02, 0.05, 0.07, 0.1)
    for op in ("<", "<=", ">", ">=", "=="):
        for v in (2557.0, 2558.5, 24.0, 24.5, 1.0):
            got = stats._for_bounds(op, torch.tensor(v), 3, 4095)
            want = jstats._for_bounds(op, jnp.float32(v), 3, 4095)
            assert [int(x) for x in got] == [int(x) for x in want]
            assert [int(x) for x in got] == list(
                stats._for_bounds(op, v, 3, 4095))
        for v in (1500, -7, 4095):
            got = stats._for_bounds(op, torch.tensor(v, dtype=torch.int32),
                                    3, 4095)
            want = jstats._for_bounds(op, jnp.int32(v), 3, 4095)
            assert [int(x) for x in got] == [int(x) for x in want]
        for v in (3e9, -3e9):
            got = stats._for_bounds(op, torch.tensor(v), 3, 4095)
            assert [int(x) for x in got] == list(
                stats._for_bounds(op, v, 3, 4095))
        for v in (0.05, 0.045, 0.0, 0.1, 0.2, -1.0):
            got = stats._dict_bounds(op, torch.tensor(v), values)
            want = jstats._dict_bounds(op, jnp.float32(v), values)
            assert [int(x) for x in got] == [int(x) for x in want]
    lanes = stats._for_bounds("<", torch.tensor([10.0, 20.5]), 3, 4095)
    assert [x.tolist() for x in lanes] == [[0, 0], [6, 17]]


def test_bin_codes_match_reference_at_the_edges():
    """Code j covers (edges[j-1], edges[j]]: a value on an edge takes the
    lower bin, as in the reference (``searchsorted`` left)."""
    edges = (10, 20, 35)
    x = np.array([-1, 10, 11, 20, 21, 35, 36, 100], np.int32)
    got = eval_expr(Bin(C("x"), edges), {"x": torch.from_numpy(x)})
    want = jax_eval_expr(JBin(JC("x"), edges), {"x": jnp.asarray(x)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 1, 1, 2, 2, 3, 3])
    np.testing.assert_array_equal(eval_expr(Bin(C("x"), edges), {"x": x}),
                                  got.numpy())


def test_scan_filter_lanes_equal_int_calls():
    """The plain B1 with (B,) bounds equals B calls with int bounds, over
    widths, negate and edge bounds (empty, negative, past the top code,
    crossed, the int32 extremes); 0-d bounds equal ints."""
    gen = np.random.default_rng(5)
    for width in (1, 3, 12, 17, 30):
        top = (1 << width) - 1
        padded, rows = 32 * 9, 32 * 9 - 13
        codes = torch.from_numpy(gen.integers(0, top + 1, (3, padded)))
        words = compression.pack_bits(codes, width)
        pairs = [(top // 3, top // 2), (-5, top // 3), (1, top + 7),
                 (top // 2 + 1, top // 2), (top + 1, top + 9), (-9, -1),
                 (-(2 ** 31), 2 ** 31 - 1), (2 ** 31 - 1, 2 ** 31 - 1)]
        lo = torch.tensor([a for a, _ in pairs], dtype=torch.int32)
        hi = torch.tensor([b for _, b in pairs], dtype=torch.int32)
        for negate in (False, True):
            kw = dict(rows=rows, padded_rows=padded, width=width,
                      negate=negate)
            lanes = ops.scan_filter(words, lo, hi, **kw)
            assert lanes.shape == (len(pairs), 3, padded // 32)
            for b, (a, z) in enumerate(pairs):
                one = ops.scan_filter(words, a, z, **kw)
                assert torch.equal(lanes[b], one)
                assert torch.equal(ops.scan_filter(words, lo[b], hi[b],
                                                   **kw), one)
            codes_ok = ((codes[None] >= lo[:, None, None])
                        & (codes[None] <= hi[:, None, None]))
            if negate:
                codes_ok = ~codes_ok
            codes_ok &= torch.arange(padded) < rows
            assert torch.equal(lanes, ref.scan_filter(words, lo, hi, rows,
                                                      padded, width, negate))
            assert torch.equal(lanes, compression.pack_bitset(codes_ok))
