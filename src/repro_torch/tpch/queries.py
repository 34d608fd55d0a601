"""TPC-H queries expressed in the declarative IR: q1, q1_kernel, q4, q6,
q14_promo and q18 (``IR_QUERIES``), and the semi-join exchange shapes
q4_sj and q18_sj.

Counterpart of ``repro.tpch.queries``.  The shared measure expressions
(``REVENUE``, ``CHARGE``) are the single source of the pricing terms.
"""
from __future__ import annotations

from repro_torch.query.ir import C, Fetch, Q, Query
from repro_torch.tpch import schema as S
from repro_torch.tpch.schema import DEFAULT_PARAMS as DP

# shared measure expressions (the TPC-H pricing terms)
REVENUE = C("l_extendedprice") * (1.0 - C("l_discount"))
CHARGE = REVENUE * (1.0 + C("l_tax"))


def q1_ir(p=DP, method: str = "auto") -> Query:
    """Pricing summary report: filter + 6-group aggregate.  The flattened
    (6, 6) result matches ``reference.q1`` (group id = returnflag*2 +
    linestatus is the row-major order of the two keys)."""
    return (
        Q.scan("lineitem")
        .filter(C("l_shipdate") <= p.q1_shipdate_max)
        .group_agg(
            keys=[("returnflag", C("l_returnflag"), len(S.RETURNFLAGS)),
                  ("linestatus", C("l_linestatus"), len(S.LINESTATUS))],
            aggs=[("sum_qty", "sum", C("l_quantity")),
                  ("sum_base_price", "sum", C("l_extendedprice")),
                  ("sum_disc_price", "sum", REVENUE),
                  ("sum_charge", "sum", CHARGE),
                  ("sum_disc", "sum", C("l_discount")),
                  ("count_order", "count")],
            method=method,
        )
        .named("q1" if method == "auto" else f"q1_{method}")
    )


def q4_ir(p=DP) -> Query:
    """Order priority checking: date window + EXISTS late-lineitem probe
    (co-partitioned scatter) + 5-group count."""
    return (
        Q.scan("orders")
        .filter((C("o_orderdate") >= p.q4_date_min)
                & (C("o_orderdate") < p.q4_date_max))
        .exists("lineitem", key="l_orderkey",
                pred=C("l_commitdate") < C("l_receiptdate"))
        .group_agg(
            keys=[("orderpriority", C("o_orderpriority"), len(S.PRIORITIES))],
            aggs=[("order_count", "count")],
        )
        .named("q4")
    )


def q6_ir(p=DP) -> Query:
    """Forecasting revenue change: pure filter + global sum (1-cell
    GroupAgg)."""
    return (
        Q.scan("lineitem")
        .filter((C("l_shipdate") >= p.q6_date_min)
                & (C("l_shipdate") < p.q6_date_max)
                & (C("l_discount") >= p.q6_disc_min)
                & (C("l_discount") <= p.q6_disc_max)
                & (C("l_quantity") < p.q6_quantity))
        .group_agg(
            aggs=[("revenue", "sum", C("l_extendedprice") * C("l_discount"))],
        )
        .named("q6")
    )


def q18_ir(p=DP, k: int = 100) -> Query:
    """Large volume customers: co-partitioned group-by onto orders, filter
    on the aggregate, global top-k, then §3.2.7 late materialization of the
    output-only attributes (customer name via the remote fetch)."""
    return (
        Q.scan("lineitem")
        .group_by_key(C("l_orderkey"), into="orders",
                      aggs=[("sum_qty", "sum", C("l_quantity"))])
        .filter(C("sum_qty") > p.q18_quantity)
        .top_k(
            value=C("o_totalprice"), k=k,
            fetch=(Fetch("o_custkey"), Fetch("o_orderdate"), Fetch("sum_qty"),
                   Fetch("c_name_code", table="customer", key="o_custkey")),
        )
        .named("q18")
    )


def q14_promo_ir(p=DP, alt: str = "auto") -> Query:
    """Promotion-effect numerator (the Q14 semi-join shape): month window
    on lineitem, remote part-type filter via the §3.2.2 semi-join — the
    lowering picks Alt-1/Alt-2 from the cost model and derives the request
    capacity from the selectivity model."""
    return (
        Q.scan("lineitem")
        .filter((C("l_shipdate") >= p.q14_date_min)
                & (C("l_shipdate") < p.q14_date_max))
        .semijoin("part", key=C("l_partkey"),
                  pred=C("p_type") < S.PROMO_TYPES, alt=alt)
        .group_agg(aggs=[("promo_revenue", "sum", REVENUE)])
        .named("q14_promo" if alt == "auto" else f"q14_promo_{alt}")
    )


def q4_sj_ir(p=DP, alt: str = "request") -> Query:
    """Q4 forced through the §3.2.2 exchange: every lineitem semi-joins its
    order's date window remotely, then the late filter and a per-order
    count give the exact Q4 result.  The request keys span the orders key
    domain."""
    return (
        Q.scan("lineitem")
        .semijoin("orders", key=C("l_orderkey"),
                  pred=(C("o_orderdate") >= p.q4_date_min)
                       & (C("o_orderdate") < p.q4_date_max),
                  alt=alt)
        .filter(C("l_commitdate") < C("l_receiptdate"))
        .group_by_key(C("l_orderkey"), into="orders",
                      aggs=[("late_cnt", "count")])
        .filter(C("late_cnt") > 0)
        .group_agg(
            keys=[("orderpriority", C("o_orderpriority"), len(S.PRIORITIES))],
            aggs=[("order_count", "count")],
        )
        .named(f"q4_sj_{alt}")
    )


def q18_sj_ir(p=DP, alt: str = "request", qty: float = 250.0,
              segment: int = DP.q3_segment) -> Query:
    """Q18 shape with a remote customer filter via the §3.2.2 semi-join:
    large-volume orders keep only customers of one market segment.  The
    request keys span the (small) customer key domain."""
    return (
        Q.scan("lineitem")
        .group_by_key(C("l_orderkey"), into="orders",
                      aggs=[("sum_qty", "sum", C("l_quantity"))])
        .filter(C("sum_qty") > qty)
        .semijoin("customer", key=C("o_custkey"),
                  pred=C("c_mktsegment") == segment, alt=alt)
        .group_agg(aggs=[("sum_qty_total", "sum", C("sum_qty")),
                         ("order_count", "count")])
        .named(f"q18_sj_{alt}")
    )


IR_QUERIES = {
    "q1": q1_ir(),
    "q1_kernel": q1_ir(method="kernel"),
    "q4": q4_ir(),
    "q6": q6_ir(),
    "q14_promo": q14_promo_ir(),
    "q18": q18_ir(),
}
