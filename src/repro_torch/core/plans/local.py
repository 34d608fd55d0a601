"""Queries whose joins are fully local thanks to co-partitioning (paper
§4.3: Q1, Q4, Q18, plus join-free Q6) — local aggregation + one collective
reduce.  Node-stacked counterpart of ``repro.core.plans.local``."""
from __future__ import annotations

import torch

from repro_torch.core import aggregation, late_materialization, topk
from repro_torch.core.engine import psum
from repro_torch.core.plans.common import (
    DEFAULT_PARAMS as DP,
    dense_local_sum,
    local_index,
    my_keys,
    revenue,
)


def _q1_measures(li):
    disc_price = revenue(li)
    charge = disc_price * (1.0 + li["l_tax"])
    return torch.stack([li["l_quantity"], li["l_extendedprice"], disc_price,
                        charge, li["l_discount"],
                        torch.ones_like(disc_price)], dim=2)


def q1(ctx, t, p=DP):
    """Pricing summary report: 6-group aggregate over lineitem, merged with a
    collective reduction (the psum of the dense 6x6 partial results)."""
    li = t["lineitem"]
    sel = li["l_shipdate"] <= p.q1_shipdate_max
    group = li["l_returnflag"] * 2 + li["l_linestatus"]
    local = aggregation.group_sum_onehot(_q1_measures(li), group, 6, sel)
    return psum(local)


def q1_kernel(ctx, t, p=DP):
    """Q1 with the fused filter + aggregate kernel (B2,
    ``kernels.ops.filtered_group_sum``) as the local scan."""
    from repro_torch.kernels import ops

    li = t["lineitem"]
    group = li["l_returnflag"] * 2 + li["l_linestatus"]
    local = ops.filtered_group_sum(
        _q1_measures(li).to(torch.float32).contiguous(),
        group.to(torch.int32).contiguous(),
        li["l_shipdate"].to(torch.int32).contiguous(),
        cutoff=int(p.q1_shipdate_max), num_groups=6)
    return psum(local)


def q6(ctx, t, p=DP):
    """Forecasting revenue change: fully local scan-filter-sum over lineitem
    plus one scalar psum."""
    li = t["lineitem"]
    sel = (
        (li["l_shipdate"] >= p.q6_date_min)
        & (li["l_shipdate"] < p.q6_date_max)
        & (li["l_discount"] >= p.q6_disc_min)
        & (li["l_discount"] <= p.q6_disc_max)
        & (li["l_quantity"] < p.q6_quantity)
    )
    rev = li["l_extendedprice"] * li["l_discount"]
    return psum(torch.where(sel, rev, 0.0).sum(dim=1))


def q4(ctx, t, p=DP):
    """Order priority checking: per-priority count of orders (date-filtered)
    having a late lineitem.  lineitem-orders are co-partitioned, so the
    EXISTS probe is a local scatter-max; one psum merges the 5 counters."""
    o = t["orders"]
    li = t["lineitem"]
    o_ok = ((o["o_orderdate"] >= p.q4_date_min)
            & (o["o_orderdate"] < p.q4_date_max))
    late = (li["l_commitdate"] < li["l_receiptdate"]).to(torch.int32)
    rows = ctx.part("orders").rows_per_node
    has_late = torch.zeros(late.shape[0], rows, dtype=torch.int32,
                           device=late.device).scatter_reduce_(
        1, local_index(ctx, "orders", li["l_orderkey"]), late, "amax")
    counts = aggregation.group_count(o["o_orderpriority"], 5,
                                     o_ok & has_late.bool())
    return psum(counts)


def q18(ctx, t, p=DP, k: int = 100):
    """Large volume customers: local group-by (co-partitioned), local top-k,
    merging reduction (§3.2.3), then late materialization (§3.2.7) of the
    output-only attributes (c_name via remote fetch, order columns local).
    The local top-k is masked, so it stays on the sort: block top-k (B4)
    differs from it on blocks that run out of unmasked rows."""
    o = t["orders"]
    li = t["lineitem"]
    qty = dense_local_sum(ctx, "orders", li["l_orderkey"], li["l_quantity"])
    sel = qty > p.q18_quantity
    local = topk.local_topk(o["o_totalprice"], my_keys(ctx, "orders"), k, sel)
    winners = topk.TopK(*(a[0] for a in topk.topk_allreduce(local)))
    # late materialization: order-side attributes from order owners…
    order_attrs = late_materialization.materialize(
        winners.keys, winners.valid, ctx.part("orders"),
        {"o_custkey": o["o_custkey"], "o_orderdate": o["o_orderdate"],
         "sum_qty": qty})
    # …then customer names from customer owners (the remote join path)
    cust_attrs = late_materialization.materialize(
        order_attrs["o_custkey"], winners.valid, ctx.part("customer"),
        {"c_name_code": t["customer"]["c_name_code"]})
    return {
        "o_totalprice": winners.values,
        "o_orderkey": winners.keys,
        "valid": winners.valid,
        "o_custkey": order_attrs["o_custkey"],
        "o_orderdate": order_attrs["o_orderdate"],
        "sum_qty": order_attrs["sum_qty"],
        "c_name_code": cust_attrs["c_name_code"],
    }
