"""TPC-H cube presets: the serving-workload rollups.

Counterpart of ``repro.tpch.cubes``.

The lineitem cube is the Q1 workhorse: (returnflag × linestatus ×
ship-month) with all six Q1 measures, so the pricing summary report is a
slice + marginalize over a 516-cell array instead of a full scan.  The
ship-month dimension's bin edges are calendar month ends PLUS the Q1
cutoff date, making the ``l_shipdate <= cutoff`` predicate exactly
answerable (bins are ``(prev_edge, edge]``).

Measures are declared with the SAME IR expressions as the registry queries
(``repro_torch.tpch.queries.REVENUE``/``CHARGE``), which is what lets the cube
router match a ``GroupAgg`` root against a spec structurally — one
definition of "revenue" across tiers.

The serving queries themselves live in ``repro_torch.tpch.queries`` (they are
plain IR queries); ``SERVING_QUERIES`` is re-exported here.
"""
from __future__ import annotations

from repro_torch.cube import CubeSpec, Dimension, Measure
from repro_torch.query.ir import C
from repro_torch.tpch import schema as S
from repro_torch.tpch.queries import (  # noqa: F401  (re-exports)
    CHARGE,
    REVENUE,
    SERVING_QUERIES,
    month_edges,
    orders_by_priority_query,
    q1_query,
    revenue_by_shipmonth_query,
    uncovered_query,
)
from repro_torch.tpch.schema import DEFAULT_PARAMS as DP


def lineitem_cube(params=DP) -> CubeSpec:
    return CubeSpec(
        name="lineitem_pricing",
        table="lineitem",
        dimensions=(
            Dimension("returnflag", "l_returnflag", len(S.RETURNFLAGS)),
            Dimension("linestatus", "l_linestatus", len(S.LINESTATUS)),
            Dimension("shipmonth", "l_shipdate", integral=True,
                      edges=month_edges(extra=(params.q1_shipdate_max,))),
        ),
        measures=(
            Measure("sum_qty", "sum", C("l_quantity")),
            Measure("sum_base_price", "sum", C("l_extendedprice")),
            Measure("sum_disc_price", "sum", REVENUE),
            Measure("sum_charge", "sum", CHARGE),
            Measure("sum_disc", "sum", C("l_discount")),
            Measure("count_order", "count"),
        ),
        rollups=(
            ("returnflag", "linestatus", "shipmonth"),
            ("returnflag", "linestatus"),
            ("shipmonth",),
        ),
    )


def orders_cube(params=DP) -> CubeSpec:
    return CubeSpec(
        name="orders_status",
        table="orders",
        dimensions=(
            Dimension("orderpriority", "o_orderpriority", len(S.PRIORITIES)),
            Dimension("orderstatus", "o_orderstatus", len(S.ORDERSTATUS)),
            Dimension("ordermonth", "o_orderdate", integral=True,
                      edges=month_edges(extra=(params.q4_date_min - 1,
                                               params.q4_date_max - 1,
                                               params.q5_date_min - 1,
                                               params.q5_date_max - 1))),
        ),
        measures=(
            Measure("count_orders", "count"),
            Measure("sum_totalprice", "sum", C("o_totalprice")),
            Measure("min_totalprice", "min", C("o_totalprice")),
            Measure("max_totalprice", "max", C("o_totalprice")),
        ),
        rollups=(
            ("orderpriority", "orderstatus", "ordermonth"),
            ("orderpriority",),
        ),
    )


def default_specs(params=DP) -> tuple:
    return (lineitem_cube(params), orders_cube(params))
