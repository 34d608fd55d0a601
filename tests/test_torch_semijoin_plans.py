"""The port's semi-join hand plans — q2, q3, q3_lazy, q3_repl, q5, q11,
q13 and q14 — through ``TPCHDriver.run(name)``, against the JAX driver's
``run(name)`` and the float64 oracle on the same tables (SF 0.01, 8 nodes;
the port on the CPU, the JAX package on the 8-device CPU mesh), and the
exchange pieces they need: ``exchange.exchange_by_owner`` on the raw and
packed wires, ``topk.lazy_filtered_topk`` (§3.2.4), q3's and q11's Alt-2
bitsets through B5, and q2's int64 composite key.

Both packages generate the tables in this one process, where their
``hash(table)`` seeding agrees, so their data is identical.  Keys, counts,
validity and overflow flags must be identical, f32 values within rtol
1e-6 of the JAX answer; against the oracle, the tolerances of
``tests/test_tpch_correctness.py``.  The JAX codec runs XLA on the CPU, so
nothing here runs a Pallas kernel in interpret mode.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from conftest import assert_topk_matches
from repro.core import exchange as jex
from repro.core import semijoin as jsj
from repro.core import topk as jtopk
from repro.core.partitioning import RangePartitioning as JaxPart
from repro.core.plans import REGISTRY as JAX_REGISTRY
from repro.tpch.schema import DEFAULT_PARAMS as JAX_DP
from repro_torch.core import compression, exchange, semijoin, topk
from repro_torch.core import plans
from repro_torch.core.partitioning import RangePartitioning
from repro_torch.core.plans import semijoin_plans as sjp
from repro_torch.kernels import ops
from repro_torch.tpch import schema as S
from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

AXIS = "nodes"
PLANS = ["q2", "q3", "q3_lazy", "q3_repl", "q5", "q11", "q13", "q14"]


@pytest.fixture(scope="module")
def port_driver():
    from repro_torch.tpch.driver import TPCHDriver

    return TPCHDriver(0.01, num_nodes=8, seed=0, device="cpu")


def _np(x):
    """Tensors and jax arrays (in dicts, tuples, NamedTuples) -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_np(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return np.asarray(x)


def _fields(name, out):
    """(arrays to compare, overflow or None) of a plan's result in either
    package: the top-k plans' (values, keys, valid), the others' value."""
    if name == "q2":
        return (out["s_acctbal"], out["part_supp_key"], out["valid"]), \
            out["overflow"]
    if name in ("q3", "q3_repl", "q11"):
        return tuple(out), None
    value, ovf = out
    return (tuple(value) if name == "q3_lazy" else (value,)), ovf


def _assert_like_jax(name, got, want):
    (gv, *grest), govf = _fields(name, got)
    (wv, *wrest), wovf = _fields(name, want)
    assert gv.dtype == np.float32 and gv.shape == wv.shape
    np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=0)
    for g, w in zip(grest, wrest, strict=True):   # keys and validity
        np.testing.assert_array_equal(g, w)
    assert (govf is None) == (wovf is None)
    if govf is not None:
        assert bool(govf) is bool(wovf) is False


def _assert_like_oracle(name, got, oracle):
    arrays, _ = _fields(name, got)
    if name == "q5":
        np.testing.assert_allclose(arrays[0], oracle, rtol=2e-4, atol=1e-2)
    elif name == "q13":
        np.testing.assert_array_equal(arrays[0], oracle)
    elif name == "q14":
        np.testing.assert_allclose(arrays[0], oracle, rtol=2e-4)
    else:
        assert_topk_matches(*arrays, *oracle)
        assert arrays[2].sum() > 0


@pytest.mark.parametrize("name", PLANS)
def test_semijoin_plan_matches_jax_and_oracle(tpch_driver, port_driver,
                                              name):
    ops.reset_launch_counts()
    if name in ("q2", "q11"):
        # at the filter chosen from this process's data (_q2_filter,
        # _q11_nation): the default one may qualify no row there
        jkw, tkw = (_q2_kwargs(port_driver, 100) if name == "q2"
                    else _q11_kwargs(port_driver))
        cols = {n: t.columns for n, t in tpch_driver.placed.items()}
        want = _np(tpch_driver.cluster.compile(
            functools.partial(JAX_REGISTRY[name].plan, **jkw),
            tpch_driver.ctx, tpch_driver.placed)(cols))
        got = _np(port_driver.cluster.compile(
            functools.partial(plans.PLANS[name], **tkw),
            port_driver.ctx)(port_driver.columns()))
        oracle = port_driver.oracle(name, **tkw)
    else:
        got = _np(port_driver.run(name))
        want = _np(tpch_driver.run(name))
        oracle = port_driver.oracle(name)
    _assert_like_jax(name, got, want)
    _assert_like_oracle(name, got, oracle)
    # the plain versions on the CPU count no launch
    assert set(ops.launch_counts().values()) == {0}


# (plan arguments, capacities): q11 at SF 1's threshold (many parts
# qualify); q3_lazy needing 100 survivors a node from chunks of 16
# candidates (several rounds; at this scale every candidate fits the
# default chunk of 256); q2 at k = 10, at the size and type filter of
# _q2_filter
OTHER_PARAMS = {"q11": ({"sf": 1.0}, {}),
                "q3_lazy": ({"k": 100}, {"q3_chunk": 16}),
                "q2": ({"k": 10}, {})}


def _q2_filter(driver, k: int) -> dict:
    """q2's (size, type finish) pair whose oracle answer at ``k`` has the
    most rows, first in (size, finish) order among ties.  The tables are
    seeded by ``hash(table)``, so they differ from process to process: at
    SF 0.01 about 8 parts pass the default filter, and one qualifying row
    is a common draw there.  Chosen from this process's data, the filter
    qualifies k rows wherever the data allows."""
    best = None
    for size in range(1, 51):
        for finish in range(S.NUM_BRASS):
            p = dataclasses.replace(DP, q2_size=size, q2_type_finish=finish)
            n = int(np.isfinite(driver.oracle("q2", p=p, k=k)[0]).sum())
            if best is None or n > best[0]:
                best = (n, size, finish)
    return {"q2_size": best[1], "q2_type_finish": best[2]}


def _q11_nation(driver) -> int:
    """q11's nation whose oracle answer has the most rows, the first
    among ties.  At SF 0.01 a part qualifies only above 1% of its
    nation's stock value, and with the per-process ``hash(table)`` seeds
    the default nation qualifies no part for some (``PYTHONHASHSEED`` 13
    and 29 of 0-40); the best nation gave 32 rows or more for each of
    those 41 seeds."""
    rows = [int(np.isfinite(driver.oracle(
        "q11", p=dataclasses.replace(DP, q11_nation=n))[0]).sum())
        for n in range(len(S.NATIONS))]
    return max(range(len(rows)), key=lambda n: (rows[n], -n))


def _q11_kwargs(driver) -> tuple:
    """q11's plan arguments at the nation of :func:`_q11_nation`, as each
    package's own ``QueryParams``: (JAX kwargs, port kwargs)."""
    nation = _q11_nation(driver)
    return ({"p": dataclasses.replace(JAX_DP, q11_nation=nation)},
            {"p": dataclasses.replace(DP, q11_nation=nation)})


def _q2_kwargs(driver, k: int) -> tuple:
    """q2's plan arguments at k and the filter of :func:`_q2_filter`, as
    each package's own ``QueryParams``: (JAX kwargs, port kwargs)."""
    chosen = _q2_filter(driver, k)
    return ({"k": k, "p": dataclasses.replace(JAX_DP, **chosen)},
            {"k": k, "p": dataclasses.replace(DP, **chosen)})


@pytest.mark.parametrize("name", sorted(OTHER_PARAMS))
def test_semijoin_plans_at_other_parameters(tpch_driver, port_driver, name,
                                            monkeypatch):
    kw, caps = OTHER_PARAMS[name]
    jkw = tkw = kw
    if name == "q2":
        jkw, tkw = _q2_kwargs(port_driver, kw["k"])
        kw = tkw
    jplan = functools.partial(JAX_REGISTRY[name].plan, **jkw)
    tplan = functools.partial(plans.PLANS[name], **tkw)
    jctx, tctx = (dataclasses.replace(c, capacities={**c.capacities, **caps})
                  for c in (tpch_driver.ctx, port_driver.ctx))
    cols = {n: t.columns for n, t in tpch_driver.placed.items()}
    want = _np(tpch_driver.cluster.compile(jplan, jctx,
                                           tpch_driver.placed)(cols))
    rounds = []
    request = semijoin.alt1_request
    monkeypatch.setattr(semijoin, "alt1_request",
                        lambda *a, **k: rounds.append(1) or request(*a, **k))
    got = _np(port_driver.cluster.compile(tplan, tctx)(
        port_driver.columns()))
    _assert_like_jax(name, got, want)
    _assert_like_oracle(name, got, port_driver.oracle(name, **kw))
    n = int(_fields(name, got)[0][2].sum())
    assert n == min(int(np.isfinite(port_driver.oracle(name, **kw)[0])
                        .sum()), len(_fields(name, got)[0][0])) > 1
    if name == "q3_lazy":
        assert len(rounds) > 1


@pytest.mark.parametrize("name,column,value",
                         [("q3", ("customer", "c_mktsegment"),
                           DP.q3_segment),
                          ("q11", ("supplier", "s_nationkey"),
                           DP.q11_nation)])
def test_alt2_bitsets_are_b5_words(tpch_driver, port_driver, monkeypatch,
                                   name, column, value):
    """The words that q3 and q11 build with B5, replicated, are the JAX
    plans' ``semijoin.alt2_bitset`` words on every node."""
    built = []
    kernel = ops.predicate_bitset

    def recording(col, *, value):
        built.append((col, value))
        return kernel(col, value=value)

    monkeypatch.setattr(ops, "predicate_bitset", recording)
    port_driver.run(name)
    (col, v), = built
    assert v == value
    got = exchange.allgather(kernel(col, value=v))
    table, cname = column

    def jplan(ctx, t):
        return jsj.alt2_bitset(t[table][cname] == value, axis=ctx.axis)

    cols = {n: t.columns for n, t in tpch_driver.placed.items()}
    want = np.asarray(tpch_driver.cluster.compile(
        jplan, tpch_driver.ctx, tpch_driver.placed)(cols))
    for row in got:
        np.testing.assert_array_equal(row.numpy().view(np.uint32), want)


# -- exchange_by_owner ------------------------------------------------------


def _owner_case(Pn, seed=3, n=40, rows=32):
    rng = np.random.default_rng(seed)
    total = Pn * rows
    keys = rng.integers(0, total, Pn * n).astype(np.int32)
    mask = rng.random(Pn * n) < 0.7
    vals = (keys * 0.5 + 0.25).astype(np.float32)   # a function of the key
    return total, keys, vals, mask


@pytest.mark.parametrize("capacity", [12, 3])        # 3 overflows
@pytest.mark.parametrize("packed", [False, True])
def test_exchange_by_owner_matches_jax(cluster, packed, capacity):
    Pn = cluster.num_nodes
    total, keys, vals, mask = _owner_case(Pn)
    jpart = JaxPart(total, Pn)
    jwf = (jex.WireFormat.packed_for(total, Pn) if packed
           else jex.WireFormat.raw())

    def fn(k, v, m):
        rk, rv, rm, ovf = jex.exchange_by_owner(
            k, v, m, jpart.owner(k), capacity=capacity, axis=AXIS,
            wire=jwf)
        return rk, rv, rm, ovf[None]

    f = jax.jit(jax.shard_map(fn, mesh=cluster.mesh,
                              in_specs=(JP(AXIS),) * 3,
                              out_specs=(JP(AXIS),) * 4, check_vma=False))
    wk, wv, wm, wovf = (np.asarray(a) for a in f(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(mask)))

    part = RangePartitioning(total, Pn)
    k = torch.from_numpy(keys).reshape(Pn, -1)
    wf = (exchange.WireFormat.packed_for(total, Pn) if packed
          else exchange.WireFormat.raw())
    exchange.reset_wire_bytes()
    rk, rv, rm, ovf = exchange.exchange_by_owner(
        k, torch.from_numpy(vals).reshape(Pn, -1),
        torch.from_numpy(mask).reshape(Pn, -1), part.owner(k),
        capacity=capacity, wire=wf)
    shipped = exchange.wire_bytes()["all-to-all"]
    shape = (Pn, Pn, capacity)
    assert rk.shape == rv.shape == rm.shape == shape
    np.testing.assert_array_equal(rk.numpy(), wk.reshape(shape))
    np.testing.assert_array_equal(rm.numpy(), wm.reshape(shape))
    assert bool(ovf) is bool(wovf.any()) is (capacity == 3)
    # every received pair is a sent one, on its owner
    np.testing.assert_array_equal(rv.numpy()[rm.numpy()],
                                  rk.numpy()[rm.numpy()] * 0.5 + 0.25)
    owners = np.arange(Pn)[:, None, None] * (total // Pn)
    got_keys = rk.numpy()
    assert ((got_keys >= owners) | ~rm.numpy()).all()
    assert ((got_keys < owners + total // Pn) | ~rm.numpy()).all()
    if not (capacity == 3 and not packed):
        # the JAX raw path writes an overflowing key's value into the
        # last slot of its full bucket; elsewhere the values are equal
        np.testing.assert_array_equal(rv.numpy(), wv.reshape(shape))
    # raw: int32 keys, f32 values and a bool mask a slot, three
    # all-to-alls; packed: one, each row the coded keys and the values
    row_bytes = (4 * (compression.packed_request_words(capacity, wf.domain)
                      + capacity) if packed else 9 * capacity)
    assert shipped == Pn * row_bytes


# -- lazy_filtered_topk ------------------------------------------------------

# Each node's candidates rank in key order (rank i holds key node * 64 + i);
# (name, valid ranks, remote filter on the rank, k, max_rounds, rounds of
# 16 candidates): done in round 1, done after several rounds, the
# candidate pool exhausted before k survivors, and max_rounds reached
LAZY_CASES = [("round_1", 64, lambda i: i % 4 != 0, 5, 8, 1),
              ("several_rounds", 64, lambda i: i % 8 == 0, 5, 8, 3),
              ("pool_exhausted", 24, lambda i: i % 4 == 0, 10, 8, 2),
              ("max_rounds", 64, lambda i: i % 8 == 0, 20, 2, 2)]


@pytest.mark.parametrize("case", LAZY_CASES, ids=[c[0] for c in LAZY_CASES])
def test_lazy_filtered_topk_matches_jax(cluster, case):
    _, valid_ranks, passes, k, max_rounds, rounds = case
    Pn, n, chunk = cluster.num_nodes, 64, 16
    node, rank = np.divmod(np.arange(Pn * n), n)
    vals = ((n - rank) * Pn + node).astype(np.float32)   # distinct
    keys = (node * n + rank).astype(np.int32)
    mask = rank < valid_ranks

    def jfilter(kk, m):
        return passes(kk % n) & m, jnp.bool_(False)

    def fn(v, kk, m):
        w, ovf = jtopk.lazy_filtered_topk(v, kk, m, jfilter, k, chunk=chunk,
                                          max_rounds=max_rounds, axis=AXIS)
        return (*w, ovf)

    f = jax.jit(jax.shard_map(fn, mesh=cluster.mesh,
                              in_specs=(JP(AXIS),) * 3, out_specs=JP(),
                              check_vma=False))
    want = [np.asarray(a) for a in f(jnp.asarray(vals), jnp.asarray(keys),
                                      jnp.asarray(mask))]
    calls = []

    def tfilter(kk, m):
        calls.append(m.sum(1))
        return passes(kk % n) & m, torch.zeros((), dtype=torch.bool)

    got, ovf = topk.lazy_filtered_topk(
        *(torch.from_numpy(a).reshape(Pn, n) for a in (vals, keys, mask)),
        tfilter, k, chunk=chunk, max_rounds=max_rounds)
    for g, w in zip(got, want[:3], strict=True):
        for row in g:                       # every node holds the answer
            np.testing.assert_array_equal(row.numpy(), w)
    assert bool(ovf) is bool(want[3]) is False
    assert len(calls) == rounds
    # nodes that are done request nothing; the winners passed the filter
    # among the ranks examined
    survivors = [passes(np.arange(r * chunk, (r + 1) * chunk)).sum()
                 for r in range(rounds)]
    for r, asked in enumerate(calls):
        done = sum(survivors[:r]) >= k
        want_asked = 0 if done else min(chunk, max(valid_ranks - r * chunk,
                                                   0))
        assert (asked == want_asked).all()
    won = got.keys[0][got.valid[0]].numpy() % n
    assert passes(won).all() and (won < rounds * chunk).all()
    assert (won < valid_ranks).all()


def test_q2_key_is_int64_past_int32():
    """At SF 10 a part key times the supplier count passes 2^31: the key
    equals numpy's int64, where the JAX plan's int32 would wrap."""
    parts = np.array([1_999_999, 1_500_000, 123_457, 0], np.float32)
    supps = np.array([99_999, 5, 77_777, 3], np.int32)
    num_sup = 100_000
    got = sjp.part_supp_key(torch.from_numpy(parts)[None],
                            torch.from_numpy(supps)[None], num_sup)
    want = parts.astype(np.int64) * num_sup + supps
    assert got.dtype == torch.int64 and want.max() > 2 ** 31
    np.testing.assert_array_equal(got[0].numpy(), want)
    wrapped = (parts.astype(np.int32) * np.int32(num_sup)
               + supps).astype(np.int64)
    assert (wrapped != want)[:2].all()


def test_replicated_segment_table(port_driver):
    """q3_repl's ``customer_seg_repl``: the customer segment column as one
    replicated 1-D column, in the catalog and the placed tables."""
    seg = port_driver.placed["customer_seg_repl"]
    assert seg.replicated and seg.columns["c_mktsegment"].ndim == 1
    np.testing.assert_array_equal(
        seg.columns["c_mktsegment"].numpy(),
        port_driver.tables["customer"].columns["c_mktsegment"])
    assert port_driver.ctx.part("customer_seg_repl").num_nodes == 1
