"""Queries aggregating on a NON-co-partitioned key (paper §4.3: Q15, Q21) —
every node holds a partial aggregate for every key; the total requires an
exchange.  Node-stacked counterpart of
``repro.core.plans.distributed_topk``.  Q15 is the paper's showcase for
the §3.2.5 approximate top-k (kernels B4 and B6); Q21 builds its Alt-2
semi-join bitset with kernel B5."""
from __future__ import annotations

import torch

from repro_torch.core import exchange, late_materialization, semijoin, topk
from repro_torch.core.plans.common import (
    DEFAULT_PARAMS as DP,
    dense_partials,
    local_index,
    my_keys,
    revenue,
)
from repro_torch.core.topk_approx import (
    approx_topk_distributed,
    simple_topk_distributed,
    sum_sources,
)
from repro_torch.kernels import ops

I64_MAX = 2 ** 63 - 1


# ---------------------------------------------------------------------------
# Q15 — top supplier (three variants, paper Fig. 4)
# ---------------------------------------------------------------------------


def _q15_partials(ctx, t, p):
    li = t["lineitem"]
    sel = ((li["l_shipdate"] >= p.q15_date_min)
           & (li["l_shipdate"] < p.q15_date_max))
    return dense_partials(ctx, "supplier", li["l_suppkey"], revenue(li), sel)


def _q15_materialize(ctx, t, winners):
    sup = t["supplier"]
    attrs = late_materialization.materialize(
        winners.keys, winners.valid, ctx.part("supplier"),
        {"s_name_code": sup["s_name_code"],
         "s_address_code": sup["s_address_code"],
         "s_phone_code": sup["s_phone_code"]})
    return {"total_revenue": winners.values, "s_suppkey": winners.keys,
            "valid": winners.valid, **attrs}


def q15(ctx, t, p=DP, k: int = 1):
    """Variant 1 (paper): ship ALL partial sums to each key's owner with the
    library all-to-all, aggregate, select the max."""
    winners = simple_topk_distributed(_q15_partials(ctx, t, p), k,
                                      backend="xla")
    return _q15_materialize(ctx, t, winners)


def q15_1factor(ctx, t, p=DP, k: int = 1):
    """Variant 2 (paper): same, but the exchange uses the 1-factor schedule
    (§3.2.6)."""
    winners = simple_topk_distributed(_q15_partials(ctx, t, p), k,
                                      backend="one_factor")
    return _q15_materialize(ctx, t, winners)


def _approx_group(ctx, requested: int) -> int:
    """Largest power-of-two group <= requested that divides the per-node key
    range (the paper's 1024, shrunk for small tables)."""
    kp = ctx.part("supplier").total_rows // ctx.num_nodes
    g = 1
    while g * 2 <= min(requested, kp) and kp % (g * 2) == 0:
        g *= 2
    return g


def q15_approx(ctx, t, p=DP, k: int = 1, m: int = 8):
    """Variant 3 (paper §3.2.5): ship m-bit approximations of every partial
    sum; exact values only for the pruned candidate set."""
    winners, stats, overflow = approx_topk_distributed(
        _q15_partials(ctx, t, p), k, m=m,
        group=_approx_group(ctx, ctx.cap("q15_group", 1024)),
        candidate_capacity=ctx.cap("q15_candidates", 256),
        backend=ctx.backend)
    out = _q15_materialize(ctx, t, winners)
    out["stats"] = stats
    out["overflow"] = overflow
    return out


# ---------------------------------------------------------------------------
# Q21 — suppliers who kept orders waiting (two variants)
# ---------------------------------------------------------------------------


def _run_counts(sorted_keys, keys):
    """How often each of ``keys`` occurs in the per-node ``sorted_keys``."""
    return (torch.searchsorted(sorted_keys, keys, right=True)
            - torch.searchsorted(sorted_keys, keys)).to(torch.int32)


def _q21_qualify(ctx, t):
    """Per-lineitem EXISTS / NOT EXISTS logic — local thanks to the
    lineitem-orders co-partitioning: 'exists another supplier's lineitem in
    this order' and 'no other supplier was late' are answered with sorted
    composite keys (order, supplier) + run-length probes.

    The composite key is int64, with a sentinel above every key.  The JAX
    plan computes it in int32, where ``rows_per_node * num_sup`` wraps from
    about SF 1.07 over 8 nodes; below that both give the same counts."""
    li = t["lineitem"]
    o = t["orders"]
    rows = ctx.part("orders").rows_per_node
    num_sup = ctx.part("supplier").total_rows
    l_order_local = local_index(ctx, "orders", li["l_orderkey"])
    delayed = li["l_receiptdate"] > li["l_commitdate"]
    P = delayed.shape[0]
    zeros = torch.zeros(P, rows, dtype=torch.int32, device=delayed.device)
    cnt_lines = zeros.scatter_add(1, l_order_local,
                                  torch.ones_like(l_order_local,
                                                  dtype=torch.int32))
    cnt_delayed = zeros.scatter_add(1, l_order_local,
                                    delayed.to(torch.int32))
    comp = l_order_local * num_sup + li["l_suppkey"].to(torch.int64)
    same_lines = _run_counts(torch.sort(comp, dim=1).values, comp)
    delayed_comp = torch.where(delayed, comp, I64_MAX)
    same_delayed = _run_counts(torch.sort(delayed_comp, dim=1).values, comp)
    status_f = torch.gather(o["o_orderstatus"], 1, l_order_local) == 0
    return (
        delayed
        & status_f
        & (torch.gather(cnt_lines, 1, l_order_local) - same_lines > 0)
        & (torch.gather(cnt_delayed, 1, l_order_local) - same_delayed == 0)
    )


def _q21_finish(ctx, t, partials, k):
    """Route dense per-supplier partial counts (L, NS) to their owners,
    aggregate, global top-k by (numwait desc, suppkey asc).  The local
    top-k is masked, so it stays on the sort."""
    P = ctx.num_nodes
    NS = ctx.part("supplier").total_rows
    recv = exchange.all_to_all(
        partials.reshape(ctx.local_nodes, P, NS // P), backend=ctx.backend)
    numwait = sum_sources(recv)
    local = topk.local_topk(numwait, my_keys(ctx, "supplier"), k,
                            numwait > 0)
    return topk.TopK(*(a[0] for a in topk.topk_allreduce(local)))


def q21(ctx, t, p=DP, k: int = 100):
    """Version 1 (paper): the supplier-nation filter is evaluated up front
    and replicated as a bitset (Alt-2, built by kernel B5); the group-by
    then counts only qualified suppliers."""
    li = t["lineitem"]
    sup = t["supplier"]
    qualify = _q21_qualify(ctx, t)
    words = exchange.allgather(ops.predicate_bitset(
        sup["s_nationkey"].to(torch.int32).contiguous(),
        value=p.q21_nation))
    nation_ok = semijoin.probe(words, li["l_suppkey"], ctx.part("supplier"))
    partials = dense_partials(ctx, "supplier", li["l_suppkey"],
                              torch.ones_like(li["l_suppkey"],
                                              dtype=torch.float32),
                              qualify & nation_ok)
    return _q21_finish(ctx, t, partials, k)


def q21_late(ctx, t, p=DP, k: int = 100):
    """Version 2 (paper 'late'): aggregate WITHOUT the nation filter, then
    request the filter bits (Alt-1) only for suppliers that actually hold a
    delayed shipment.  Returns (TopK, overflow)."""
    li = t["lineitem"]
    sup = t["supplier"]
    qualify = _q21_qualify(ctx, t)
    partials = dense_partials(ctx, "supplier", li["l_suppkey"],
                              torch.ones_like(li["l_suppkey"],
                                              dtype=torch.float32), qualify)
    active = partials > 0
    sup_part = ctx.part("supplier")
    all_sup_keys = torch.arange(sup_part.total_rows, dtype=torch.int32,
                                device=partials.device).expand_as(partials)

    def nation_pred(local_idx, mask):
        return (torch.gather(sup["s_nationkey"], 1,
                             local_idx.to(torch.int64))
                == p.q21_nation) & mask

    bits, ovf = semijoin.alt1_request(
        all_sup_keys, active, sup_part, nation_pred,
        capacity=ctx.cap("q21_request", 1024), backend=ctx.backend,
        wire=ctx.wire_fmt("q21_request"))
    partials = torch.where(bits, partials, 0.0)
    return _q21_finish(ctx, t, partials, k), ovf
