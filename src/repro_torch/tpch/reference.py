"""Pure-numpy oracles for the TPC-H queries this port answers (q1, q6).

A copy of the q1 and q6 oracles of ``repro.tpch.reference``.  They operate
on the GLOBAL (unpartitioned) host tables in float64 — the correctness
baseline every plan must match ("we check the query results for
correctness", paper §4.1).
"""
from __future__ import annotations

import numpy as np

from repro_torch.tpch.schema import DEFAULT_PARAMS as DP


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


ALL = {"q1": q1, "q6": q6}
