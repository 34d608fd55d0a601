"""Queries with remote filter attributes (paper §4.3: Q2, Q3, Q5, Q11, Q13,
Q14) — each exercises one of the §3.2.2 semi-join alternatives, the §3.2.4
lazy top-k, or the owner-routed group-by.  Node-stacked counterpart of
``repro.core.plans.semijoin_plans``.  The Alt-2 bitsets of Q3 and Q11 are
built by kernel B5, as Q21's is."""
from __future__ import annotations

import torch

from repro_torch.core import aggregation, exchange, semijoin, topk
from repro_torch.core.engine import psum
from repro_torch.core.plans.common import (
    DEFAULT_PARAMS as DP,
    dense_local_sum,
    local_index,
    my_keys,
    revenue,
)
from repro_torch.kernels import ops
from repro_torch.tpch import schema as S


def _gather(column, index):
    """Per-node lookup: column (P, rows)[p, index[p, i]]."""
    return torch.gather(column, 1, index.to(torch.int64))


def _first(t: topk.TopK) -> topk.TopK:
    """The replicated answer of a merging reduction: node 0's row."""
    return topk.TopK(*(a[0] for a in t))


def _alt2_bitset(column, value):
    """Alt-2 semi-join: each owner packs ``column == value`` over its
    partition with kernel B5, and the words are replicated to every node
    (the words of ``semijoin.alt2_bitset``)."""
    return exchange.allgather(ops.predicate_bitset(
        column.to(torch.int32).contiguous(), value=value))


# ---------------------------------------------------------------------------
# Q2 — minimum cost supplier (remote filter on supplier region, Alt-1)
# ---------------------------------------------------------------------------


def part_supp_key(partkeys, suppkeys, num_suppliers: int):
    """Q2's composite (partkey, suppkey) key, the answer and its tiebreak,
    in int64: the JAX plan's int32 key wraps from about SF 1.04 (part keys
    times the supplier count past 2^31); below that both are equal.  The
    part keys arrive as float32, exact below 2^24."""
    return (partkeys.to(torch.int64) * num_suppliers
            + suppkeys.to(torch.int64))


def q2(ctx, t, p=DP, k: int = 100):
    part = t["part"]
    ps = t["partsupp"]
    sup = t["supplier"]
    sup_part = ctx.part("supplier")
    # local filters on part; partsupp co-partitioned with part
    psel = ((part["p_size"] == p.q2_size)
            & (part["p_type"] % S.NUM_BRASS == p.q2_type_finish))
    ps_local_part = local_index(ctx, "part", ps["ps_partkey"])
    ps_part_ok = _gather(psel, ps_local_part)

    # remote region filter on supplier, requested explicitly (Alt-1: only
    # ~0.4% of partsupps survive the local filter)
    def region_pred(local_idx, mask):
        return (S.nation_region(_gather(sup["s_nationkey"], local_idx))
                == p.q2_region) & mask

    bits, ovf1 = semijoin.alt1_request(
        ps["ps_suppkey"], ps_part_ok, sup_part, region_pred,
        capacity=ctx.cap("q2_request", 512), backend=ctx.backend,
        wire=ctx.wire_fmt("q2_request"))
    cand = ps_part_ok & bits
    # min supplycost per part (local: partsupp co-partitioned with part)
    cost = ps["ps_supplycost"]
    mincost = torch.full((cost.shape[0], ctx.part("part").rows_per_node),
                         float("inf"), device=cost.device)
    mincost.scatter_reduce_(1, ps_local_part,
                            torch.where(cand, cost, float("inf")), "amin")
    is_min = cand & (cost == torch.gather(mincost, 1, ps_local_part))
    # ship (suppkey -> partkey) pairs to the supplier owners, who rank them
    # by their local s_acctbal
    recv_sup, recv_part, recv_mask, ovf2 = exchange.exchange_by_owner(
        ps["ps_suppkey"], ps["ps_partkey"].to(torch.float32), is_min,
        sup_part.owner(ps["ps_suppkey"]),
        capacity=ctx.cap("q2_owner", 512), backend=ctx.backend,
        wire=ctx.wire_fmt("q2_owner"))
    P = recv_sup.shape[0]
    rs = recv_sup.reshape(P, -1).to(torch.int64)
    rm = recv_mask.reshape(P, -1)
    mine = torch.where(rm, rs, sup_part.my_base(rs.device))
    bal = _gather(sup["s_acctbal"], local_index(ctx, "supplier", mine))
    comp = part_supp_key(recv_part.reshape(P, -1), rs, sup_part.total_rows)
    winners = _first(topk.topk_allreduce(topk.local_topk(bal, comp, k, rm)))
    return {"s_acctbal": winners.values, "part_supp_key": winners.keys,
            "valid": winners.valid, "overflow": ovf1 | ovf2}


# ---------------------------------------------------------------------------
# Q3 — shipping priority: Alt-2 bitset version + §3.2.4 lazy version
# ---------------------------------------------------------------------------


def _q3_revenue_per_order(ctx, t, p, order_mask):
    li = t["lineitem"]
    l_order_local = local_index(ctx, "orders", li["l_orderkey"])
    sel = (li["l_shipdate"] > p.q3_date) & _gather(order_mask,
                                                   l_order_local)
    return dense_local_sum(ctx, "orders", li["l_orderkey"], revenue(li), sel)


def _q3_top(ctx, rev, k):
    local = topk.local_topk(rev, my_keys(ctx, "orders"), k, rev > 0)
    return _first(topk.topk_allreduce(local))


def q3(ctx, t, p=DP, k: int = 10):
    """Version 1 (paper): evaluate the customer-segment filter once,
    replicate the bitset (Alt-2, built by kernel B5), then aggregate fully
    locally."""
    o = t["orders"]
    words = _alt2_bitset(t["customer"]["c_mktsegment"], p.q3_segment)
    o_ok = (o["o_orderdate"] < p.q3_date) & semijoin.probe(
        words, o["o_custkey"], ctx.part("customer"))
    return _q3_top(ctx, _q3_revenue_per_order(ctx, t, p, o_ok), k)


def q3_lazy(ctx, t, p=DP, k: int = 10):
    """Version 2 (paper §3.2.4): aggregate on local data only, then lazily
    request the remote customer filter for chunks of locally best orders.
    Returns (TopK, overflow)."""
    o = t["orders"]
    cust = t["customer"]
    rev = _q3_revenue_per_order(ctx, t, p, o["o_orderdate"] < p.q3_date)
    cust_part = ctx.part("customer")

    def seg_pred(local_idx, mask):
        return (_gather(cust["c_mktsegment"], local_idx)
                == p.q3_segment) & mask

    def remote_filter(order_keys, mask):
        custkeys = _gather(o["o_custkey"],
                           local_index(ctx, "orders", order_keys))
        return semijoin.alt1_request(
            custkeys, mask, cust_part, seg_pred,
            capacity=ctx.cap("q3_chunk", 256), backend=ctx.backend,
            wire=ctx.wire_fmt("q3_request"))

    winners, overflow = topk.lazy_filtered_topk(
        rev, my_keys(ctx, "orders"), rev > 0, remote_filter, k,
        chunk=ctx.cap("q3_chunk", 256), max_rounds=ctx.cap("q3_rounds", 64))
    return _first(winners), overflow


def q3_repl(ctx, t, p=DP, k: int = 10):
    """Version 3 (paper 'repl'): the remote join attribute (c_mktsegment) is
    replicated at load time — fully local evaluation."""
    o = t["orders"]
    seg_all = t["customer_seg_repl"]["c_mktsegment"]   # replicated column
    o_ok = ((o["o_orderdate"] < p.q3_date)
            & (seg_all[o["o_custkey"].to(torch.int64)] == p.q3_segment))
    return _q3_top(ctx, _q3_revenue_per_order(ctx, t, p, o_ok), k)


# ---------------------------------------------------------------------------
# Q5 — local supplier volume (replicated small column + Alt-1 request)
# ---------------------------------------------------------------------------


def q5(ctx, t, p=DP):
    """Returns (revenue per nation (25,), overflow)."""
    o = t["orders"]
    li = t["lineitem"]
    cust = t["customer"]
    # the supplier table is small: replicate its nation column (paper: "we
    # distribute their nation over all nodes")
    s_nat_all = exchange.allgather(t["supplier"]["s_nationkey"])
    o_ok = ((o["o_orderdate"] >= p.q5_date_min)
            & (o["o_orderdate"] < p.q5_date_max))
    # request the customer's nation for date-qualified orders (the Alt-1
    # reply is a value, not a bit: the same request/reply exchange)
    cust_part = ctx.part("customer")

    def nation_lookup(req_keys, mask):
        local_idx = cust_part.local_index(req_keys)
        return torch.where(mask, _gather(cust["c_nationkey"], local_idx), -1)

    c_nat_order, ovf = exchange.request_reply(
        o["o_custkey"], o_ok, cust_part.owner(o["o_custkey"]),
        nation_lookup, capacity=ctx.cap("q5_request", 2048),
        backend=ctx.backend, reply_dtype=torch.int32,
        wire=ctx.wire_fmt("q5_request"))
    l_order_local = local_index(ctx, "orders", li["l_orderkey"])
    l_sup_nat = _gather(s_nat_all, li["l_suppkey"])
    sel = (_gather(o_ok, l_order_local)
           & (S.nation_region(l_sup_nat) == p.q5_region)
           & (_gather(c_nat_order, l_order_local) == l_sup_nat))
    rev = aggregation.group_sum_onehot(revenue(li), l_sup_nat, 25, sel)
    return psum(rev), ovf


# ---------------------------------------------------------------------------
# Q11 — important stock (Alt-2 bitset; threshold from a global allreduce)
# ---------------------------------------------------------------------------


def q11(ctx, t, p=DP, cap: int = 128, sf: float | None = None):
    ps = t["partsupp"]
    sf = ctx.scale_factor if sf is None else sf
    # no locally evaluable filter: replicate the nation bitset (paper),
    # built by kernel B5
    words = _alt2_bitset(t["supplier"]["s_nationkey"], p.q11_nation)
    sel = semijoin.probe(words, ps["ps_suppkey"], ctx.part("supplier"))
    value = ps["ps_supplycost"] * ps["ps_availqty"]
    per_part = dense_local_sum(ctx, "part", ps["ps_partkey"], value, sel)
    total = psum(per_part.sum(1))                  # allreduce (paper)
    thresh = total * (p.q11_fraction / sf)
    local = topk.local_topk(per_part, my_keys(ctx, "part"), cap,
                            per_part > thresh)
    return _first(topk.topk_allreduce(local))


# ---------------------------------------------------------------------------
# Q13 — customer distribution (owner-routed group-by on a remote key)
# ---------------------------------------------------------------------------


def q13(ctx, t, p=DP, hist_cap: int = 64):
    """Returns (histogram of orders per customer (hist_cap,), overflow)."""
    o = t["orders"]
    cust_part = ctx.part("customer")
    # ship the qualified order -> customer keys to the customers' owners
    recv_keys, recv_vals, recv_mask, ovf = exchange.exchange_by_owner(
        o["o_custkey"], torch.ones_like(o["o_custkey"], dtype=torch.float32),
        ~o["o_comment_special"], cust_part.owner(o["o_custkey"]),
        capacity=ctx.cap("q13_route", 4096), backend=ctx.backend,
        wire=ctx.wire_fmt("q13_route"))
    P = recv_keys.shape[0]
    rows = cust_part.rows_per_node
    local_idx = torch.where(recv_mask, recv_keys.to(torch.int64)
                            - cust_part.my_base(recv_keys.device)[..., None],
                            rows).reshape(P, -1)
    # received pairs of no customer land in a spill column, dropped
    counts = torch.zeros(P, rows + 1, dtype=torch.float32,
                         device=recv_vals.device).scatter_add_(
        1, local_idx, torch.where(recv_mask, recv_vals, 0.0).reshape(P, -1))
    # histogram over per-customer order counts (0 orders included: the
    # SQL left outer join)
    c_count = torch.clamp(counts[:, :rows].to(torch.int32), max=hist_cap - 1)
    return psum(aggregation.group_count(c_count, hist_cap)), ovf


# ---------------------------------------------------------------------------
# Q14 — promotion effect (Alt-1 request on part type)
# ---------------------------------------------------------------------------


def q14(ctx, t, p=DP):
    """Returns ([promo share %, promo revenue, revenue], overflow)."""
    li = t["lineitem"]
    part = t["part"]
    sel = ((li["l_shipdate"] >= p.q14_date_min)
           & (li["l_shipdate"] < p.q14_date_max))

    def promo_pred(local_idx, mask):
        return (_gather(part["p_type"], local_idx) < S.PROMO_TYPES) & mask

    promo, ovf = semijoin.alt1_request(
        li["l_partkey"], sel, ctx.part("part"), promo_pred,
        capacity=ctx.cap("q14_request", 2048), backend=ctx.backend,
        wire=ctx.wire_fmt("q14_request"))
    rev = revenue(li)
    total = psum(torch.where(sel, rev, 0.0).sum(1))
    promo_rev = psum(torch.where(sel & promo, rev, 0.0).sum(1))
    return torch.stack([100.0 * promo_rev / total, promo_rev, total]), ovf
