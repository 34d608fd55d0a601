"""The port's hand-written plans — q1, q1_kernel, q6, q4, q18 (local) and
q15, q15_1factor, q15_approx, q21, q21_late (distributed top-k) — through
``TPCHDriver.run(name)``, against the JAX driver's ``run(name)`` and the
float64 oracle on the same tables (SF 0.01, 8 nodes; the port on the CPU,
the JAX package on the 8-device CPU mesh).

Both packages generate the tables in this one process, where their
``hash(table)`` seeding agrees, so their data is identical.  Keys, counts,
validity, overflow flags and the §3.2.5 statistics must be identical; the
top-k plans' f32 values within rtol 1e-6 of the JAX answer, the q1 and q6
sums over ~10,000 rows within 1e-5 (another summation order), all within
2e-4 of the oracle.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from conftest import assert_topk_matches
from repro.core.plans import REGISTRY as JAX_REGISTRY
from repro.tpch import capacities as jcap
from repro.tpch.schema import DEFAULT_PARAMS as JAX_DP
from repro_torch.core import plans
from repro_torch.core.plans import distributed_topk as tdt
from repro_torch.core.plans import local as tlocal
from repro_torch.kernels import ops
from repro_torch.query.ir import LoweringError, UnknownPlanError
from repro_torch.tpch import capacities as tcap
from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

HAND_PLANS = ["q1", "q1_kernel", "q6", "q4", "q18", "q15", "q15_1factor",
              "q15_approx", "q21", "q21_late"]
# tests/test_torch_semijoin_plans.py holds these against the JAX package
SEMIJOIN_PLANS = ["q2", "q3", "q3_lazy", "q3_repl", "q5", "q11", "q13",
                  "q14"]
Q15_ATTRS = ("s_name_code", "s_address_code", "s_phone_code")
Q18_ATTRS = ("o_custkey", "o_orderdate", "sum_qty", "c_name_code")


@pytest.fixture(scope="module")
def port_driver():
    from repro_torch.tpch.driver import TPCHDriver

    return TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """torch tensors (in dicts, tuples, NamedTuples) -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_t(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _topk_fields(name, out):
    """(values, keys, valid, extra dict, overflow or None) of a top-k
    plan's result in either package."""
    if name.startswith("q15"):
        extra = {a: out[a] for a in Q15_ATTRS}
        return (out["total_revenue"], out["s_suppkey"], out["valid"], extra,
                out.get("overflow"))
    if name == "q18":
        return (out["o_totalprice"], out["o_orderkey"], out["valid"],
                {a: out[a] for a in Q18_ATTRS}, None)
    ovf = None
    if name == "q21_late":
        out, ovf = out
    return out[0], out[1], out[2], {}, ovf


def _assert_topk_like_jax(name, got, want, oracle):
    gv, gk, gm, gx, govf = _topk_fields(name, got)
    wv, wk, wm, wx, wovf = _topk_fields(name, want)
    assert gv.dtype == np.float32 and gv.shape == wv.shape
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_allclose(gv, wv, rtol=1e-6)
    for attr, w in wx.items():
        np.testing.assert_array_equal(gx[attr], w, err_msg=attr)
    if wovf is not None:
        assert bool(govf) is bool(wovf) is False
    ov, ok = oracle
    n = int(gm.sum())
    assert n == min(int(np.isfinite(ov).sum()), len(gv))
    exact = name.startswith("q21")
    assert_topk_matches(gv, gk, gm, ov, ok, rtol=0 if exact else 2e-4,
                        atol=0)
    np.testing.assert_array_equal(gk[:n], ok[:n])
    return n


@pytest.mark.parametrize("name", HAND_PLANS)
def test_hand_plan_matches_jax_and_oracle(tpch_driver, port_driver, name):
    ops.reset_launch_counts()
    got = _t(port_driver.run(name))
    want = _np(tpch_driver.run(name))
    oracle = port_driver.oracle(name)
    if name in ("q1", "q1_kernel", "q6", "q4"):
        assert got.dtype == np.float32 and got.shape == want.shape
        if name == "q4":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, oracle)
        else:
            # f32 sums of ~10,000 rows, XLA's dot against torch's matmul
            # (q1 reads 1.13e-6 relative): the 1e-5 of the lowered q1/q6
            # tests (test_torch_slice.py)
            np.testing.assert_allclose(got, want, rtol=1e-5)
            np.testing.assert_allclose(got, oracle, rtol=2e-4)
    else:
        _assert_topk_like_jax(name, got, want, oracle)
    if name == "q15_approx":
        assert all(np.array_equal(g, w)
                   for g, w in zip(got["stats"], want["stats"]))
        assert (float(got["stats"].approx_bits_per_node)
                < float(got["stats"].naive_bits_per_node))
    # the plain versions on the CPU count no launch
    assert set(ops.launch_counts().values()) == {0}


# the top-k plans at other parameters: k = 10 suppliers for q15 (k = 1 is a
# plain maximum), a q18 quantity with winners at this scale (none pass 300)
OTHER_PARAMS = {"q15": {"k": 10}, "q15_1factor": {"k": 10},
                "q15_approx": {"k": 10},
                "q18": {"p": {"q18_quantity": 150.0}},
                "q21": {"k": 5}, "q21_late": {"k": 5}}


@pytest.mark.parametrize("name", sorted(OTHER_PARAMS))
def test_topk_plans_at_other_parameters(tpch_driver, port_driver, name):
    kw = dict(OTHER_PARAMS[name])
    jkw, tkw = dict(kw), dict(kw)
    if "p" in kw:
        jkw["p"] = dataclasses.replace(JAX_DP, **kw["p"])
        tkw["p"] = dataclasses.replace(DP, **kw["p"])
    jplan = functools.partial(JAX_REGISTRY[name].plan, **jkw)
    tplan = functools.partial(plans.PLANS[name], **tkw)
    cols = {n: t.columns for n, t in tpch_driver.placed.items()}
    want = _np(tpch_driver.cluster.compile(jplan, tpch_driver.ctx,
                                           tpch_driver.placed)(cols))
    got = _t(port_driver.cluster.compile(tplan, port_driver.ctx)(
        port_driver.columns()))
    n = _assert_topk_like_jax(name, got, want,
                              port_driver.oracle(name, **tkw))
    assert n > 1
    if name == "q15_approx":
        assert all(np.array_equal(g, w)
                   for g, w in zip(got["stats"], want["stats"]))


def test_q21_int64_key_counts_equal_jax(tpch_driver, port_driver):
    """q21's qualifying lineitems per supplier: the port's int64 composite
    key gives the JAX plan's int32 counts wherever int32 does not wrap."""
    from jax import lax

    from repro.core.plans import common as jcommon
    from repro.core.plans import distributed_topk as jdt
    from repro_torch.core.engine import psum
    from repro_torch.core.plans import common as tcommon

    def jplan(ctx, t):
        return lax.psum(jcommon.dense_partials(
            ctx, "supplier", t["lineitem"]["l_suppkey"],
            jax.numpy.ones_like(t["lineitem"]["l_suppkey"], jax.numpy.float32),
            jdt._q21_qualify(ctx, t)), ctx.axis)

    def tplan(ctx, t):
        li = t["lineitem"]
        return psum(tcommon.dense_partials(
            ctx, "supplier", li["l_suppkey"],
            torch.ones_like(li["l_suppkey"], dtype=torch.float32),
            tdt._q21_qualify(ctx, t)))

    cols = {n: t.columns for n, t in tpch_driver.placed.items()}
    want = np.asarray(tpch_driver.cluster.compile(
        jplan, tpch_driver.ctx, tpch_driver.placed)(cols))
    got = port_driver.cluster.compile(tplan, port_driver.ctx)(
        port_driver.columns()).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_q21_bitset_is_the_alt2_bitset(tpch_driver, port_driver):
    """q21 builds its Alt-2 bitset with B5: the words of the JAX plan's
    ``alt2_bitset(s_nationkey == nation)`` on every node."""
    from repro.core import semijoin as jsj
    from repro_torch.core import exchange

    def jplan(ctx, t):
        return jsj.alt2_bitset(t["supplier"]["s_nationkey"] == DP.q21_nation,
                               axis=ctx.axis)

    cols = {n: t.columns for n, t in tpch_driver.placed.items()}
    want = np.asarray(tpch_driver.cluster.compile(
        jplan, tpch_driver.ctx, tpch_driver.placed)(cols))
    nation = port_driver.placed["supplier"].columns["s_nationkey"].decode()
    got = exchange.allgather(ops.predicate_bitset(nation,
                                                  value=DP.q21_nation))
    for row in got:
        np.testing.assert_array_equal(row.numpy().view(np.uint32), want)


@pytest.mark.parametrize("ctx_kw", [{"backend": "one_factor"},
                                    {"wire": "raw"}])
@pytest.mark.parametrize("name", ["q15_approx", "q21_late"])
def test_exchange_settings_do_not_change_the_answer(port_driver, name,
                                                    ctx_kw):
    """The all-to-all backend and the q21 request's wire are the context's;
    the answers equal the driver's own (xla, packed)."""
    ctx = dataclasses.replace(port_driver.ctx, **ctx_kw)
    got = _t(port_driver.cluster.compile(plans.PLANS[name], ctx)(
        port_driver.columns()))
    want = _t(port_driver.run(name))
    for g, w in zip(_topk_fields(name, got)[:3], _topk_fields(name, want)[:3]):
        np.testing.assert_array_equal(g, w)


def _run_bytes(fn):
    from repro_torch.core import exchange

    exchange.reset_wire_bytes()
    out = _t(fn())
    return out, exchange.wire_bytes()["all-to-all"]


def test_cluster_run_ships_named_exchanges_in_their_wire_format(
        port_driver):
    """``Cluster.run(..., wires=...)`` hands a hand plan the wire formats
    of its named exchanges, as the reference's ``Cluster.run`` does: q21's
    packed request then ships the bytes and gives the answer of
    ``TPCHDriver.run``.  Without ``wires`` the exchange falls back to
    raw, with the same answer and more bytes."""
    name, d = "q21_late", port_driver
    plan = plans.PLANS[name]
    kw = dict(scale_factor=d.sf)
    want, want_bytes = _run_bytes(lambda: d.run(name))
    wires = tcap.wire_formats(d.tables, d.cluster.num_nodes)
    assert wires["q21_request"].kind == "packed"
    got, got_bytes = _run_bytes(lambda: d.cluster.run(
        plan, d.resident, d.capacities, wires=wires, **kw))
    raw, raw_bytes = _run_bytes(lambda: d.cluster.run(
        plan, d.resident, d.capacities, **kw))
    for g, r, w in zip(_topk_fields(name, got)[:3],
                       _topk_fields(name, raw)[:3],
                       _topk_fields(name, want)[:3]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(r, w)
    assert got_bytes == want_bytes > 0
    assert raw_bytes > want_bytes


def test_registry_matches_jax():
    """The same names, oracle bindings and plan/IR presence as the JAX
    registry for every query, the semi-join plans included: nothing is
    left refused, and an unknown name raises."""
    assert set(plans.REGISTRY) == set(JAX_REGISTRY)
    for name, entry in plans.REGISTRY.items():
        ref = JAX_REGISTRY[name]
        assert plans.get(name) is entry
        assert entry.oracle == ref.oracle, name
        assert (entry.plan is None) == (ref.plan is None), name
        assert (entry.ir is None) == (ref.ir is None), name
        if entry.plan is not None:
            assert entry.plan.__name__ == ref.plan.__name__, name
    with pytest.raises(UnknownPlanError, match="unknown query"):
        plans.get("q99")
    assert set(plans.PLANS) == set(HAND_PLANS) | set(SEMIJOIN_PLANS)


def test_capacities_and_wire_formats_match_jax(tpch_driver, port_driver):
    for sf in (0.01, 1.0, 10.0):
        assert tcap.derive(sf, 8) == jcap.derive(sf, 8)
    mine = tcap.wire_formats(port_driver.tables, 8)
    ref = jcap.wire_formats(tpch_driver.tables, 8)
    assert {n: (w.kind, w.domain, w.key_bits) for n, w in mine.items()} == {
        n: (w.kind, w.domain, w.key_bits) for n, w in ref.items()}
    assert port_driver.capacities == tpch_driver.capacities
    w, jw = (port_driver.ctx.wire_fmt("q21_request"),
             tpch_driver.ctx.wire_fmt("q21_request"))
    assert (w.kind, w.domain, w.key_bits) == (jw.kind, jw.domain,
                                              jw.key_bits)
    raw = dataclasses.replace(port_driver.ctx, wire="raw")
    assert raw.wire_fmt("q21_request").kind == "raw"
    assert port_driver.ctx.wire_fmt("no_such_exchange").kind == "raw"


def test_query_runs_hand_plans_and_splits_overflow(port_driver):
    """``query(name)`` of a plan without IR runs the hand plan and surfaces
    its overflow flag beside the value, as the JAX driver does."""
    ans = port_driver.query("q21_late")
    assert ans.source == "q21_late" and ans.overflow is False
    assert torch.equal(ans.value.keys, port_driver.run("q21").keys)
    ans = port_driver.query("q15_approx")
    assert ans.overflow is False and "overflow" not in ans.value
    assert port_driver.query("q21").overflow is False
    with pytest.raises(LoweringError, match="hand-written plan"):
        port_driver.query("q15", wire="raw")
    with pytest.raises(LoweringError, match="no IR definition"):
        port_driver.run_ir("q15")
    with pytest.raises(UnknownPlanError, match="unknown query"):
        port_driver.run("q99")
    ans = port_driver.query("q13")    # a semi-join plan without IR
    assert ans.source == "q13" and ans.overflow is False
    assert ans.value.shape == (64,)
    # q1 has both: run() takes the hand plan, run_ir() the lowering
    assert port_driver.compile("q1").plan is tlocal.q1
    assert port_driver.compile_ir("q1").plan.handles_packed


def test_hand_plans_decode_only_the_columns_they_read(port_driver,
                                                      monkeypatch):
    """Plan entry decodes a packed column when the plan first reads it, as
    XLA drops the decodes a compiled JAX plan never reads."""
    from repro_torch.core.columnar import PackedColumn

    decoded = []
    real = PackedColumn.decode

    def counting(self):
        decoded.append(self)
        return real(self)

    monkeypatch.setattr(PackedColumn, "decode", counting)
    out = port_driver.run("q6")
    assert out.shape == ()
    li = port_driver.placed["lineitem"].columns
    read = {"l_shipdate", "l_discount", "l_quantity", "l_extendedprice"}
    want = [c for n, c in li.items() if n in read
            and isinstance(c, PackedColumn)]
    assert len(decoded) == len(want) and all(
        any(d is c for d in decoded) for c in want)
