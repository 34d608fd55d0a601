"""TPC-H queries expressed in the declarative IR, for the queries this port
lowers (q1, q1_kernel, q6).

Counterpart of ``repro.tpch.queries``.  The shared measure expressions
(``REVENUE``, ``CHARGE``) are the single source of the pricing terms.
"""
from __future__ import annotations

from repro_torch.query.ir import C, Q, Query
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


IR_QUERIES = {
    "q1": q1_ir(),
    "q1_kernel": q1_ir(method="kernel"),
    "q6": q6_ir(),
}
