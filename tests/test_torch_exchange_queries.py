"""The port's second slice — the exchange queries q4_sj, q18_sj, q14_promo,
q4 and q18 — against the JAX package and the float64 oracle on the same
tables (SF 0.01, 8 nodes; the port on the CPU).

Both packages generate the tables in this one process, where their
``hash(table)`` seeding agrees, so their data is identical.  Floats agree
with the JAX answer within rtol 1e-5 (f32 sums in another order); counts,
keys and fetched attributes exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.roofline import parse_collective_bytes
from repro.query import parameterize as jax_parameterize
from repro.query.lower import lower as jax_lower
from repro.tpch import queries as jq
from repro_torch.core import exchange
from repro_torch.kernels import ops
from repro_torch.query.lower import lower
from repro_torch.tpch import queries as tq
from repro_torch.tpch.schema import DEFAULT_PARAMS as DP


@pytest.fixture(scope="module")
def port_driver():
    from repro_torch.tpch.driver import TPCHDriver

    return TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu")


_JAX = {}


def _jax_run(drv, q, wire="packed"):
    """The JAX plan's answer and its all-to-all operand bytes per device
    (from the compiled HLO), for ``q`` prepared as the JAX driver's
    ``query`` prepares it (its literals parameterized, its capacities
    sized from their values) and lowered under ``wire``; cached."""
    key = (q.name, repr(q.root), wire)
    if key not in _JAX:
        import jax.numpy as jnp

        shape, binding = jax_parameterize(q)
        plan = jax_lower(shape, drv.catalog, wire=wire, binding=binding)
        ctx = dataclasses.replace(drv.ctx, wire=wire, backend="xla")
        cols = {n: t.columns for n, t in drv.placed.items()}
        fn = drv.cluster.compile(plan, ctx, drv.placed)
        pv = {p.name: jnp.asarray(np.asarray(binding[p.name],
                                             np.dtype(p.dtype)))
              for p in plan.params}
        compiled = fn.lower(cols, pv).compile()
        out = {k: np.asarray(v) for k, v in compiled(cols, pv).items()}
        stats = parse_collective_bytes(compiled.as_text())
        _JAX[key] = out, stats.bytes_by_op.get("all-to-all", 0)
    return _JAX[key]


def _port_run(drv, q, *, wire="packed", backend="xla"):
    """The port's plan dict under ``wire`` and ``backend``, and its
    per-node all-to-all bytes."""
    exchange.reset_wire_bytes()
    out = drv.compile_query(q, wire=wire, backend=backend)(drv.columns())
    return out, exchange.wire_bytes()["all-to-all"]


def _sj_fields(plans, wire_fields):
    return [(p.alt, p.capacity, p.key, wire_fields(p.wire), p.table,
             p.gamma, p.derived_capacity) for p in plans]


SJ_QUERIES = {"q4_sj": (tq.q4_sj_ir, jq.q4_sj_ir),
              "q18_sj": (tq.q18_sj_ir, jq.q18_sj_ir),
              "q14_promo": (tq.q14_promo_ir, jq.q14_promo_ir)}


@pytest.mark.parametrize("alt", ["auto", "request", "bitset"])
@pytest.mark.parametrize("name", sorted(SJ_QUERIES))
@pytest.mark.parametrize("wire", ["packed", "raw"])
def test_semijoin_plans_match_jax(tpch_driver, port_driver, name, alt, wire):
    mine_q, jax_q = SJ_QUERIES[name]
    mine = lower(mine_q(alt=alt), port_driver.catalog, wire=wire).semijoins
    ref = jax_lower(jax_q(alt=alt), tpch_driver.catalog, wire=wire).semijoins
    assert len(mine) == 1
    fields = (lambda w: (w.kind, w.domain, w.key_bits))
    assert _sj_fields(mine, fields) == _sj_fields(ref, fields)


def _assert_value(out, want, oracle, oracle_rtol, *, exact=False):
    """The port's value against the JAX answer (exactly for integer-valued
    sums and counts, else rtol 1e-5) and the float64 oracle."""
    assert not bool(out.get("overflow", False))
    got = out["value"].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    if oracle_rtol == 0:
        np.testing.assert_array_equal(got.reshape(np.shape(oracle)), oracle)
    else:
        np.testing.assert_allclose(got.reshape(np.shape(oracle)), oracle,
                                   rtol=oracle_rtol)


@pytest.mark.parametrize("backend", ["xla", "one_factor"])
@pytest.mark.parametrize("wire", ["packed", "raw"])
@pytest.mark.parametrize("name", ["q4_sj", "q18_sj"])
def test_exchange_query_matches_jax_and_oracle(tpch_driver, port_driver,
                                               name, wire, backend):
    mine_q, jax_q = SJ_QUERIES[name]
    want, _ = _jax_run(tpch_driver, jax_q(), wire=wire)
    out, _ = _port_run(port_driver, mine_q(), wire=wire, backend=backend)
    oracle = port_driver.oracle(f"{name}_request")
    # both are integer-valued: q4_sj counts orders, q18_sj sums integer
    # quantities (exact in f32 below 2**24, whatever the order of the
    # scatter-adds); the oracle tolerance of q18_sj is q14's
    _assert_value(out, want["value"], oracle, 0 if name == "q4_sj" else 2e-4,
                  exact=True)
    if name == "q4_sj":
        np.testing.assert_array_equal(oracle, tpch_driver.oracle("q4"))


@pytest.mark.parametrize("wire", ["packed", "raw"])
@pytest.mark.parametrize("name", ["q4_sj", "q18_sj"])
def test_all_to_all_bytes_equal_jax_hlo(tpch_driver, port_driver, name,
                                        wire):
    """Per-node all-to-all bytes of the port's exchange equal the operand
    bytes of the JAX plan's compiled all-to-alls: bytes do not depend on
    hardware."""
    mine_q, jax_q = SJ_QUERIES[name]
    _, jax_bytes = _jax_run(tpch_driver, jax_q(), wire=wire)
    ops.reset_launch_counts()
    _, got = _port_run(port_driver, mine_q(), wire=wire)
    assert jax_bytes > 0 and got == jax_bytes
    if wire == "packed":
        _, raw = _port_run(port_driver, mine_q(), wire="raw")
        assert got < raw
    # on the CPU the codec runs its plain versions: no kernel launches
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("alt", ["auto", "request", "bitset"])
def test_q14_promo_matches_jax_and_oracle(tpch_driver, port_driver, alt):
    want, _ = _jax_run(tpch_driver, jq.q14_promo_ir(alt=alt))
    out, _ = _port_run(port_driver, tq.q14_promo_ir(alt=alt))
    assert ("overflow" in out) == (alt == "request")
    oracle = port_driver.oracle(tq.q14_promo_ir(alt=alt).name)
    np.testing.assert_array_equal(oracle, tpch_driver.oracle("q14")[1])
    _assert_value(out, want["value"], oracle, 2e-4)


def test_q4_matches_jax_and_oracle(tpch_driver, port_driver):
    out = port_driver.run_ir("q4")
    want = np.asarray(tpch_driver.run_ir("q4")["value"])
    _assert_value(out, want, port_driver.oracle("q4"), 0, exact=True)
    np.testing.assert_array_equal(port_driver.oracle("q4"),
                                  tpch_driver.oracle("q4"))


@pytest.mark.parametrize("qty", [DP.q18_quantity, 200.0])
def test_q18_matches_jax_and_oracle(tpch_driver, port_driver, qty):
    """Top-k with late materialization: keys exactly, values as the
    oracle's, and the fetched attributes equal to the host table rows."""
    p = dataclasses.replace(DP, q18_quantity=qty)
    jp = dataclasses.replace(jq.DP, q18_quantity=qty)
    out, _ = _port_run(port_driver, tq.q18_ir(p))
    want, _ = _jax_run(tpch_driver, jq.q18_ir(jp))
    assert "overflow" not in out
    got = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["values"], want["values"], rtol=1e-5)
    for name in ("keys", "o_custkey", "o_orderdate", "sum_qty",
                 "c_name_code"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ov, ok = port_driver.oracle("q18", p=p)
    n = int(got["valid"].sum())
    assert n == int(np.isfinite(ov).sum())
    if qty == 200.0:
        assert n > 0
    k = got["keys"][:n]
    np.testing.assert_array_equal(k, ok[:n])
    np.testing.assert_allclose(got["values"][:n], ov[:n], rtol=2e-4)
    orders = port_driver.tables["orders"].columns
    cust = port_driver.tables["customer"].columns
    np.testing.assert_array_equal(got["o_custkey"][:n],
                                  orders["o_custkey"][k])
    np.testing.assert_array_equal(got["o_orderdate"][:n],
                                  orders["o_orderdate"][k])
    np.testing.assert_array_equal(got["c_name_code"][:n],
                                  cust["c_name_code"][orders["o_custkey"][k]])


def test_driver_answers_the_registered_exchange_queries(port_driver):
    """``run_ir`` and ``query`` on the registry names; ``query`` surfaces
    the overflow flag beside the value."""
    for name in ("q4", "q14_promo", "q18"):
        ans = port_driver.query(name)
        assert ans.source == name and ans.overflow is False
    assert isinstance(port_driver.query("q18").value, dict)
    ans = port_driver.query(tq.q14_promo_ir(alt="request"))
    assert ans.overflow is False
    np.testing.assert_allclose(ans.value.numpy().reshape(()),
                               port_driver.oracle("q14_promo_request"),
                               rtol=2e-4)


@pytest.mark.parametrize("wire", ["packed", "raw"])
def test_driver_binds_wire_and_backend_in_one_place(port_driver, wire):
    """``compile_query``/``query`` set the lowering's wire (the plan's
    semi-join decision) and the shipped wire together; the answer does not
    depend on either, and only the packed wire launches the codec."""
    fn = port_driver.compile_query(tq.q18_sj_ir(), wire=wire,
                                   backend="one_factor")
    assert [sj.wire.kind for sj in fn.plan.semijoins] == [wire]
    _, want = _port_run(port_driver, tq.q18_sj_ir(), wire=wire)
    exchange.reset_wire_bytes()
    ans = port_driver.query(tq.q18_sj_ir(), wire=wire, backend="one_factor")
    assert exchange.wire_bytes()["all-to-all"] == want
    assert ans.overflow is False
    # the driver's own settings (packed, xla) give the same answer
    np.testing.assert_array_equal(
        ans.value.numpy(), port_driver.query(tq.q18_sj_ir()).value.numpy())


def test_capacity_override_sets_overflow():
    """An explicit capacity override under '<name>_sj<i>' reaches the
    request exchange: one slot per destination overflows."""
    from repro_torch.tpch.driver import TPCHDriver

    d = TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu",
                   capacities={"q14_promo_request_sj0": 1})
    out = d.compile_query(tq.q14_promo_ir(alt="request"))(d.columns())
    assert bool(out["overflow"])
    assert d.query(tq.q14_promo_ir(alt="request")).overflow is True


def test_wire_auto_names_the_missing_calibration(port_driver, tmp_path,
                                                monkeypatch):
    """wire='auto' chooses by the port's wire calibration: one that
    $REPRO_TORCH_WIRE_CAL names but that is missing raises, naming it."""
    from repro_torch.core import wirecal

    missing = tmp_path / "no_card_calibration.json"
    monkeypatch.setenv(wirecal.ENV_VAR, str(missing))
    with pytest.raises(wirecal.WireCalError, match="no_card_calibration"):
        lower(tq.q14_promo_ir(), port_driver.catalog, wire="auto")


def test_exists_and_group_by_key_validate_like_jax(port_driver):
    from repro_torch.query.ir import C, IRValidationError, Q

    with pytest.raises(IRValidationError, match="co-partitioned"):
        lower(Q.scan("orders").exists("partsupp", key="ps_partkey",
                                      pred=C("ps_availqty") > 0)
              .group_agg(aggs=[("n", "count")]), port_driver.catalog)
    with pytest.raises(IRValidationError, match="co-partitioned"):
        lower(Q.scan("lineitem").group_by_key(C("l_partkey"), into="orders",
                                              aggs=[("n", "count")])
              .group_agg(aggs=[("n2", "count")]), port_driver.catalog)
    with pytest.raises(IRValidationError, match="key="):
        lower(Q.scan("orders").top_k(
            C("o_totalprice"), 5,
            fetch=[tq.Fetch("c_name_code", table="customer", key="x")]),
            port_driver.catalog)
    assert torch.is_tensor(port_driver.run_ir("q4")["value"])
