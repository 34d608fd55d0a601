"""Pure-numpy oracles for the TPC-H queries this port answers.

A copy of the q1, q4, q6, q14 and q18 oracles of ``repro.tpch.reference``
and of the q18_sj oracle of ``benchmarks/exchange_compression.py``.  They
operate on the GLOBAL (unpartitioned) host tables in float64 — the
correctness baseline every plan must match ("we check the query results
for correctness", paper §4.1).  Rankings use (value desc, key asc) like
the plans, so top-k sets compare deterministically.
"""
from __future__ import annotations

import numpy as np

from repro_torch.tpch import schema as S
from repro_torch.tpch.schema import DEFAULT_PARAMS as DP


def _topk(values, keys, k):
    """(value desc, key asc) ranking; returns (values, keys) padded with
    (-inf, -1) when fewer than k rows qualify."""
    values = np.asarray(values, np.float64)
    keys = np.asarray(keys, np.int64)
    order = np.lexsort((keys, -values))[:k]
    out_v = np.full(k, -np.inf)
    out_k = np.full(k, -1, np.int64)
    out_v[: len(order)] = values[order]
    out_k[: len(order)] = keys[order]
    return out_v, out_k


def q1(t, p=DP):
    li = t["lineitem"].columns
    sel = li["l_shipdate"] <= p.q1_shipdate_max
    rf = li["l_returnflag"][sel]
    ls = li["l_linestatus"][sel]
    g = rf * 2 + ls
    qty = li["l_quantity"][sel].astype(np.float64)
    price = li["l_extendedprice"][sel].astype(np.float64)
    disc = li["l_discount"][sel].astype(np.float64)
    tax = li["l_tax"][sel].astype(np.float64)
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    out = np.zeros((6, 6))
    for col, v in enumerate([qty, price, disc_price, charge, disc, np.ones_like(qty)]):
        np.add.at(out[:, col], g, v)
    return out  # [sum_qty, sum_base, sum_disc_price, sum_charge, sum_disc, count]


def q6(t, p=DP):
    li = t["lineitem"].columns
    sel = (
        (li["l_shipdate"] >= p.q6_date_min)
        & (li["l_shipdate"] < p.q6_date_max)
        & (li["l_discount"] >= p.q6_disc_min)
        & (li["l_discount"] <= p.q6_disc_max)
        & (li["l_quantity"] < p.q6_quantity)
    )
    rev = li["l_extendedprice"].astype(np.float64) * li["l_discount"].astype(np.float64)
    return rev[sel].sum()


def q4(t, p=DP):
    orders = t["orders"].columns
    li = t["lineitem"].columns
    o_ok = ((orders["o_orderdate"] >= p.q4_date_min)
            & (orders["o_orderdate"] < p.q4_date_max))
    late = li["l_commitdate"] < li["l_receiptdate"]
    has_late = np.zeros(orders["o_orderkey"].shape[0], bool)
    has_late[li["l_orderkey"][late]] = True
    sel = o_ok & has_late
    return np.bincount(orders["o_orderpriority"][sel],
                       minlength=5).astype(np.float64)


def q14(t, p=DP):
    li = t["lineitem"].columns
    part = t["part"].columns
    sel = ((li["l_shipdate"] >= p.q14_date_min)
           & (li["l_shipdate"] < p.q14_date_max))
    promo = (part["p_type"] < S.PROMO_TYPES)[li["l_partkey"]]
    rev = (li["l_extendedprice"] * (1 - li["l_discount"])).astype(np.float64)
    total = rev[sel].sum()
    promo_rev = rev[sel & promo].sum()
    return np.array([100.0 * promo_rev / total, promo_rev, total])


def _order_quantity(orders, li):
    """Total quantity per order, float64 (``np.bincount`` adds in input
    order, as ``np.add.at`` does, and is much faster at SF 10)."""
    return np.bincount(li["l_orderkey"],
                       weights=li["l_quantity"].astype(np.float64),
                       minlength=orders["o_orderkey"].shape[0])


def q18(t, p=DP, k=100):
    li = t["lineitem"].columns
    orders = t["orders"].columns
    qty = _order_quantity(orders, li)
    sel = qty > p.q18_quantity
    return _topk(orders["o_totalprice"].astype(np.float64)[sel],
                 orders["o_orderkey"][sel], k)


def q18_sj(t, qty: float = 250.0, segment: int = DP.q3_segment):
    """[sum of the per-order quantities, number of orders] over orders
    with total quantity above ``qty`` whose customer is in ``segment``."""
    o = t["orders"].columns
    li = t["lineitem"].columns
    c = t["customer"].columns
    sq = _order_quantity(o, li)
    sel = (sq > qty) & (c["c_mktsegment"][o["o_custkey"]] == segment)
    return np.array([sq[sel].sum(), sel.sum()])


ALL = {"q1": q1, "q4": q4, "q6": q6, "q14": q14, "q18": q18,
       "q18_sj": q18_sj}
