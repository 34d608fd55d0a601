"""Pure-numpy oracles for the TPC-H queries this port answers.

A copy of the q1, q2, q3, q4, q5, q6, q11, q13, q14, q15, q18 and q21
oracles of ``repro.tpch.reference`` (sums by ``np.bincount``, which adds
in input order as ``np.add.at`` does and is much faster at SF 10) and of
the q18_sj oracle of ``benchmarks/exchange_compression.py``.  They
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


def q5(t, p=DP):
    cust = t["customer"].columns
    orders = t["orders"].columns
    li = t["lineitem"].columns
    sup = t["supplier"].columns
    o_ok = ((orders["o_orderdate"] >= p.q5_date_min)
            & (orders["o_orderdate"] < p.q5_date_max))
    s_nat = sup["s_nationkey"]
    s_ok = S.nation_region(s_nat) == p.q5_region
    l_sup_nat = s_nat[li["l_suppkey"]]
    l_cust = orders["o_custkey"][li["l_orderkey"]]
    sel = (o_ok[li["l_orderkey"]] & s_ok[li["l_suppkey"]]
           & (cust["c_nationkey"][l_cust] == l_sup_nat))
    # revenue per nation (only the region's nations are nonzero)
    return np.bincount(l_sup_nat[sel], weights=_revenue(li, sel),
                       minlength=25)


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


def q2(t, p=DP, k=100):
    part = t["part"].columns
    ps = t["partsupp"].columns
    sup = t["supplier"].columns
    psel = ((part["p_size"] == p.q2_size)
            & (part["p_type"] % S.NUM_BRASS == p.q2_type_finish))
    s_in_region = S.nation_region(sup["s_nationkey"]) == p.q2_region
    cand = psel[ps["ps_partkey"]] & s_in_region[ps["ps_suppkey"]]
    cost = ps["ps_supplycost"].astype(np.float64)
    mincost = np.full(part["p_partkey"].shape[0], np.inf)
    np.minimum.at(mincost, ps["ps_partkey"][cand], cost[cand])
    lowest = mincost[ps["ps_partkey"]]
    is_min = cand & (cost <= lowest + 1e-6) & (cost >= lowest - 1e-6)
    # result rows: (acctbal of supplier, composite key part * NS + supp)
    num_sup = sup["s_suppkey"].shape[0]
    comp = (ps["ps_partkey"][is_min].astype(np.int64) * num_sup
            + ps["ps_suppkey"][is_min])
    bal = sup["s_acctbal"].astype(np.float64)[ps["ps_suppkey"][is_min]]
    return _topk(bal, comp, k)


def _revenue(li, sel):
    return (li["l_extendedprice"][sel]
            * (1 - li["l_discount"][sel])).astype(np.float64)


def q3(t, p=DP, k=10):
    cust = t["customer"].columns
    orders = t["orders"].columns
    li = t["lineitem"].columns
    c_ok = cust["c_mktsegment"] == p.q3_segment
    o_ok = (orders["o_orderdate"] < p.q3_date) & c_ok[orders["o_custkey"]]
    lsel = (li["l_shipdate"] > p.q3_date) & o_ok[li["l_orderkey"]]
    rev = np.bincount(li["l_orderkey"][lsel], weights=_revenue(li, lsel),
                      minlength=orders["o_orderkey"].shape[0])
    return _topk(rev[rev > 0], orders["o_orderkey"][rev > 0], k)


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


def q11(t, p=DP, sf: float = 1.0, cap: int = 128):
    ps = t["partsupp"].columns
    sup = t["supplier"].columns
    sel = (sup["s_nationkey"] == p.q11_nation)[ps["ps_suppkey"]]
    value = (ps["ps_supplycost"].astype(np.float64)
             * ps["ps_availqty"]).astype(np.float64)
    per_part = np.bincount(ps["ps_partkey"][sel], weights=value[sel],
                           minlength=t["part"].columns["p_partkey"].shape[0])
    thresh = per_part.sum() * p.q11_fraction / sf
    qualified = per_part > thresh
    return _topk(per_part[qualified], np.nonzero(qualified)[0], cap)


def q13(t, p=DP, hist_cap: int = 64):
    orders = t["orders"].columns
    cust = t["customer"].columns
    sel = ~orders["o_comment_special"]
    counts = np.bincount(orders["o_custkey"][sel],
                         minlength=cust["c_custkey"].shape[0])
    counts = np.minimum(counts, hist_cap - 1)
    return np.bincount(counts, minlength=hist_cap).astype(np.float64)


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


def q15(t, p=DP, k=1):
    li = t["lineitem"].columns
    sup = t["supplier"].columns
    sel = ((li["l_shipdate"] >= p.q15_date_min)
           & (li["l_shipdate"] < p.q15_date_max))
    rev = (li["l_extendedprice"][sel]
           * (1 - li["l_discount"][sel])).astype(np.float64)
    total = np.bincount(li["l_suppkey"][sel], weights=rev,
                        minlength=sup["s_suppkey"].shape[0])
    return _topk(total, np.arange(total.shape[0]), k)


def q21(t, p=DP, k=100):
    """Composite (order, supplier) keys in int64: no wrap at any scale."""
    li = t["lineitem"].columns
    orders = t["orders"].columns
    sup = t["supplier"].columns
    num_sup = sup["s_suppkey"].shape[0]
    delayed = li["l_receiptdate"] > li["l_commitdate"]
    lo = li["l_orderkey"].astype(np.int64)
    norders = orders["o_orderkey"].shape[0]
    cnt_lines = np.bincount(lo, minlength=norders)
    cnt_delayed = np.bincount(lo[delayed], minlength=norders)
    comp = lo * num_sup + li["l_suppkey"]
    uniq, inv, counts = np.unique(comp, return_inverse=True,
                                  return_counts=True)
    same_lines = counts[inv]
    uniq_d, counts_d = np.unique(comp[delayed], return_counts=True)
    same_delayed_u = np.zeros(len(uniq), np.int64)
    same_delayed_u[np.searchsorted(uniq, uniq_d)] = counts_d
    same_delayed = same_delayed_u[inv]
    status_f = orders["o_orderstatus"][lo] == 0
    nation_ok = (sup["s_nationkey"] == p.q21_nation)[li["l_suppkey"]]
    qualify = (
        delayed
        & status_f
        & nation_ok
        & (cnt_lines[lo] - same_lines > 0)
        & (cnt_delayed[lo] - same_delayed == 0)
    )
    numwait = np.bincount(li["l_suppkey"][qualify], minlength=num_sup)
    sel = numwait > 0
    return _topk(numwait[sel].astype(np.float64), np.nonzero(sel)[0], k)


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


ALL = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6,
       "q11": q11, "q13": q13, "q14": q14, "q15": q15, "q18": q18,
       "q18_sj": q18_sj, "q21": q21}
