"""The port's first slice against the JAX package on the same data: storage
(packing specs and words), the lowered q1 / q1_kernel / q6 answers, the
scan decisions, and the float64 oracle.

Both packages generate the tables in this one process, where the
``hash(table)`` seeding of the generators agrees, so their data is
identical.  The port runs on the CPU (plain versions of its kernels).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.columnar import PackedColumn as JaxPackedColumn
from repro_torch.core.columnar import PackedColumn, table_from_numpy


@pytest.fixture(scope="module")
def port_driver():
    from repro_torch.tpch.driver import TPCHDriver

    return TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


# -- storage -----------------------------------------------------------------


def test_dbgen_packing_bit_identical(tpch_driver, port_driver):
    jax_li = tpch_driver.resident["lineitem"].columns
    port_li = port_driver.resident["lineitem"].columns
    assert set(jax_li) == set(port_li)
    packed = 0
    for name, jcol in jax_li.items():
        pcol = port_li[name]
        if not isinstance(jcol, JaxPackedColumn):
            assert not isinstance(pcol, PackedColumn), name
            np.testing.assert_array_equal(pcol.numpy().reshape(-1),
                                          np.asarray(jcol), err_msg=name)
            continue
        packed += 1
        assert isinstance(pcol, PackedColumn), name
        spec = ("rows", "padded_rows", "width", "offset", "values", "dtype",
                "num_nodes")
        assert ({k: getattr(pcol, k) for k in spec}
                == {k: getattr(jcol, k) for k in spec}), name
        np.testing.assert_array_equal(
            _u32(pcol.words).reshape(-1), np.asarray(jcol.words),
            err_msg=name)
    assert packed >= 10   # every lineitem column but the price is packed


def test_table_from_numpy_decodes_like_jax(tpch_driver):
    jt = tpch_driver.resident["lineitem"]
    cols = {}
    for name, col in jt.columns.items():
        if isinstance(col, JaxPackedColumn):
            cols[name] = {"words": np.asarray(col.words), "rows": col.rows,
                          "padded_rows": col.padded_rows,
                          "width": col.width, "offset": col.offset,
                          "values": col.values, "dtype": col.dtype,
                          "num_nodes": col.num_nodes}
        else:
            cols[name] = np.asarray(col)
    t = table_from_numpy("lineitem", cols, jt.dictionaries,
                         num_nodes=tpch_driver.cluster.num_nodes)
    assert t.num_rows == jt.num_rows
    for name, col in t.columns.items():
        dense = col.decode() if isinstance(col, PackedColumn) else col
        want = tpch_driver.tables["lineitem"].columns[name]
        assert dense.shape == (8, want.shape[0] // 8)
        np.testing.assert_array_equal(dense.numpy().reshape(-1),
                                      np.asarray(want), err_msg=name)


# -- the slice ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["q1", "q1_kernel", "q6"])
def test_lowered_query_matches_jax_and_oracle(tpch_driver, port_driver, name):
    got = port_driver.run_ir(name)["value"]
    assert got.dtype == torch.float32
    want = np.asarray(tpch_driver.run_ir(name)["value"])
    assert tuple(got.shape) == want.shape
    # f32 sums in another order than XLA's
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    oracle = np.asarray(port_driver.oracle(name))
    np.testing.assert_allclose(got.numpy().reshape(oracle.shape), oracle,
                               rtol=2e-4)
    np.testing.assert_allclose(oracle, tpch_driver.oracle(name), rtol=0)


@pytest.mark.parametrize("name", ["q1", "q1_kernel", "q6"])
def test_scan_decisions_match_jax(tpch_driver, port_driver, name):
    from repro.query.lower import lower as jax_lower
    from repro.tpch.queries import IR_QUERIES as JAX_QUERIES
    from repro_torch.query.lower import lower
    from repro_torch.tpch.queries import IR_QUERIES

    mine = lower(IR_QUERIES[name], port_driver.catalog).scans
    ref = jax_lower(JAX_QUERIES[name], tpch_driver.catalog).scans
    key = ("table", "column", "mode", "width", "rows_per_node", "scan_bytes",
           "raw_bytes")
    assert ([tuple(getattr(d, k) for k in key) for d in mine]
            == [tuple(getattr(d, k) for k in key) for d in ref])
    assert ([d.rewrite.static_bounds() + (d.rewrite.negate,) for d in mine]
            == [d.rewrite.static_bounds() + (d.rewrite.negate,)
                for d in ref])
    if name == "q6":  # five conjuncts fuse into three scans
        assert [d.column for d in mine] == ["l_shipdate", "l_discount",
                                            "l_quantity"]


def test_query_with_other_literals_matches_jax(tpch_driver, port_driver):
    """``query(q)`` lowers an ad-hoc IR query with literal predicates; a
    dictionary column, a negated test and a decode-mode conjunct.  The
    float literals are exact in float32 or off its grid: the JAX package
    compares a literal in float64 when it lowers it as written, in float32
    when ``query`` turns it into a parameter, and the two differ on a
    literal like 0.05 that float32 rounds."""
    from repro.query import C as JC, Q as JQ
    from repro_torch.query.ir import C, Q

    def build(q, c):
        return (q.scan("lineitem")
                .filter((c("l_discount") != 0.0) & (c("l_tax") <= 0.045)
                        & (c("l_shipdate") > 1000)
                        & (c("l_commitdate") < c("l_receiptdate")))
                .group_agg(keys=[("rf", c("l_returnflag"), 3)],
                           aggs=[("rev", "sum", c("l_extendedprice")
                                  * (1.0 - c("l_discount"))),
                                 ("n", "count")])
                .named("adhoc"))

    got = port_driver.query(build(Q, C)).value
    want = np.asarray(tpch_driver.query(build(JQ, JC)).value)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_packed_scan_decodes_only_what_the_plan_touches(port_driver):
    """Decode on first touch: q6 scans l_shipdate packed and never expands
    it; only the aggregate's columns are decoded."""
    from repro_torch.core import columnar
    from repro_torch.tpch.queries import IR_QUERIES

    decoded = []
    orig = columnar.PackedColumn.decode

    def spy(self):
        decoded.append(self.width)
        return orig(self)

    widths = {n: c.width for n, c in
              port_driver.placed["lineitem"].columns.items()
              if isinstance(c, PackedColumn)}
    plan = port_driver.compile_query(IR_QUERIES["q6"])
    columnar.PackedColumn.decode = spy
    try:
        plan(port_driver.columns())
    finally:
        columnar.PackedColumn.decode = orig
    # l_extendedprice is raw; l_discount (dictionary) is the one decode
    assert decoded == [widths["l_discount"]]


@pytest.mark.parametrize("method", ["onehot", "dense"])
def test_q1_group_agg_methods_match_jax(tpch_driver, port_driver, method):
    """The explicit one-hot and dense (scatter-add) GroupAgg lowerings."""
    from repro.tpch.queries import q1_ir as jax_q1_ir
    from repro_torch.tpch.queries import q1_ir

    got = port_driver.query(q1_ir(method=method)).value
    want = np.asarray(tpch_driver.query(jax_q1_ir(method=method)).value)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_raw_storage_matches_packed(port_driver):
    """Raw residency filters on decoded columns; the answers agree."""
    from repro_torch.tpch.driver import TPCHDriver

    raw = TPCHDriver(0.01, num_nodes=8, seed=0, storage="raw", device="cpu")
    assert not any(isinstance(c, PackedColumn)
                   for c in raw.placed["lineitem"].columns.values())
    assert raw.resident_bytes > port_driver.resident_bytes
    for name in ("q1", "q1_kernel", "q6"):
        np.testing.assert_allclose(raw.run_ir(name)["value"].numpy(),
                                   port_driver.run_ir(name)["value"].numpy(),
                                   rtol=1e-6)
