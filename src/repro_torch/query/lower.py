"""Lowering pass: logical IR -> physical node-stacked plan.

Counterpart of ``repro.query.lower``.  ``lower(query, catalog)`` compiles
an IR tree into a plan function with the engine's signature ``plan(ctx,
tables)``; ``Cluster.compile`` binds it.  Every tensor in the plan carries
the leading node axis, so the plan body runs once for all P nodes and
synchronizes only through the collectives of :mod:`repro_torch.core.
exchange` (``psum`` is a sum over the node axis).

Physical mapping:

- ``Filter``  -> each conjunct over a packed column is rewritten into a
  code-space range test and evaluated on the packed words by the scan
  kernel (``kernels.ops.scan_filter``); same-column tests fuse into one
  scan, the scans AND in word space, and ONE bitset unpack yields the row
  mask.  Other conjuncts run on the decoded columns.
- ``Project`` -> vectorized column ops.
- ``SemiJoin`` -> a local probe for co-partitioned edges, else Alt-1 (the
  request exchange, Elias–Fano coded on the packed wire) or Alt-2 (the
  replicated bitset), chosen by the byte-accurate §3.2.2 cost model; the
  request capacity comes from the selectivity model (``query.stats``).
- ``Exists`` -> co-partitioned scatter probe.
- ``GroupAggByKey`` -> dense scatter-add over the parent partition.
- ``GroupAgg`` -> per-measure masked sums (one group), a one-hot matmul
  (``onehot``), a dense scatter-add (``dense``), or the fused
  filter + grouped-aggregation kernel (``kernel``,
  ``kernels.ops.filtered_group_sum``), then ``psum``.
- ``TopK`` -> per-node top-k + the §3.2.3 merging reduction, fetching the
  output attributes of the k winners only (§3.2.7).

Packed columns decode on first touch only (:class:`_LazyCols`): a column
read only by the scan kernel is never expanded.

Lowered plans return ``{"value"}`` for ``GroupAgg`` roots and ``{"values",
"keys", "valid", <fetched attributes>}`` for ``TopK`` roots.  A plan with a
request exchange also returns ``"overflow"``: True iff a derived buffer
capacity was exceeded, and the answer is then incomplete; override the
capacity in ``PlanContext.capacities`` under ``"<query-name>_sj<i>"`` (the
i-th semi-join of the chain).  Min/max aggregates raise
:class:`LoweringError`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import (
    aggregation,
    compression,
    late_materialization,
    scancal,
    semijoin,
    topk,
)
from repro_torch.core.columnar import PackedColumn
from repro_torch.core.compression import choose_semijoin_wire
from repro_torch.core.engine import psum
from repro_torch.core.exchange import WireFormat
from repro_torch.kernels import ops
from repro_torch.query import stats as qstats
from repro_torch.query.ir import (
    BinOp,
    Catalog,
    Col,
    Exists,
    Filter,
    GroupAgg,
    GroupAggByKey,
    Lit,
    LoweringError,
    Project,
    Query,
    Scan,
    SemiJoin,
    TopK,
    conjuncts,
    eval_expr,
    expr_columns,
    validate,
)

ONEHOT_MAX_GROUPS = 8192
KERNEL_MAX_GROUPS = 512


def _chain(root) -> list:
    """Operator chain scan-first (every operator here is single-child)."""
    out = []
    node = root
    while not isinstance(node, Scan):
        out.append(node)
        node = node.child
    out.append(node)
    return out[::-1]


@dataclasses.dataclass(frozen=True)
class _SemiJoinPlan:
    alt: str        # local | request | bitset
    capacity: int   # request-exchange bucket capacity (0 if unused)
    key: str = ""   # PlanContext.capacities override key ("<name>_sj<i>")
    wire: WireFormat = WireFormat.raw()  # wire format of the exchange
    table: str = ""     # semi-join target table
    gamma: float = 0.0  # predicted target-predicate selectivity
    # the model's request capacity whatever the chosen alternative
    derived_capacity: int = 0


def _decide_semijoins(root, catalog: Catalog, query_name=None,
                      wire: str = "packed") -> dict:
    """Each SemiJoin's physical alternative and buffer capacity from the
    §3.2.2 model, with selectivities accumulated along the chain.  The
    choice is byte-accurate: the static wire bytes of the Alt-1 exchange at
    its derived capacity and packed widths under ``wire``, against the
    Alt-2 bitset allgather."""
    decisions = {}
    base = None
    sel = 1.0
    for node in _chain(root):
        if isinstance(node, Scan):
            base = node.table
            sel = 1.0
            continue
        tinfo = catalog.table(base)
        if isinstance(node, Filter):
            sel *= qstats.estimate_selectivity(node.pred, tinfo.stats)
        elif isinstance(node, Exists):
            sel *= qstats.DEFAULT_SELECTIVITY
        elif isinstance(node, GroupAggByKey):
            base = node.into
            sel = 1.0
        elif isinstance(node, SemiJoin):
            target = catalog.table(node.table)
            gamma = qstats.estimate_selectivity(node.pred, target.stats)
            edge = catalog.copartitioned.get(base)
            local_ok = (
                edge is not None and edge[0] == node.table
                and isinstance(node.key, Col) and node.key.name == edge[1]
            )
            alt = node.alt
            if alt == "local" and not local_ok:
                raise LoweringError(
                    f"semijoin alt='local' requires {node.table!r} "
                    f"co-partitioned with {base!r} on the key column"
                )
            P = max(catalog.num_nodes, 1)
            if local_ok:
                # co-partitioned keys all route to their own node when
                # forced through the request exchange: the self-bucket
                # takes everything (and every other bucket gets the same
                # capacity, unused)
                cap = qstats.capacity_for(tinfo.num_rows / P * sel)
            else:
                cap = qstats.request_capacity(tinfo.num_rows, sel,
                                              catalog.num_nodes)
            wf = qstats.wire_format_for(target.num_rows, catalog.num_nodes,
                                        kind=wire)
            if alt == "auto":
                if local_ok:
                    alt = "local"
                else:
                    choice = choose_semijoin_wire(
                        cap, target.num_rows, P, domain=wf.domain,
                        packed=wf.packed)
                    alt = "request" if choice == 1 else "bitset"
            decisions[id(node)] = _SemiJoinPlan(
                alt=alt, capacity=cap if alt == "request" else 0,
                key=f"{query_name or 'query'}_sj{len(decisions)}",
                wire=wf, table=node.table, gamma=gamma,
                derived_capacity=cap,
            )
            sel *= gamma
    return decisions


def _decide_scans(root, catalog: Catalog, cal=None) -> dict:
    """Per-Filter predicate-on-packed decisions over compressed-resident
    base tables: each ``col op literal`` conjunct against a packed column
    rewrites into a code-space range test; the :mod:`scancal` roofline
    arbitrates packed vs decode per column; same-column range tests fuse
    into one scan.  Returns ``{id(filter): [(conjuncts_tuple,
    [ScanDecision, ...]), ...]}`` for filters touching a packed column."""
    if cal is None:
        cal = scancal.BUILTIN
    decisions = {}
    base = None
    for node in _chain(root):
        if isinstance(node, Scan):
            base = node.table
            continue
        if isinstance(node, GroupAggByKey):
            base = node.into
            continue
        if not isinstance(node, Filter):
            continue
        tinfo = catalog.table(base)
        if not tinfo.packed:
            continue
        rows = tinfo.num_rows // max(catalog.num_nodes, 1)
        per = [(conj, qstats.decide_scan_conjunct(conj, base, tinfo.packed,
                                                  rows, cal=cal))
               for conj in conjuncts(node.pred)]
        if any(ds for _, ds in per):
            decisions[id(node)] = qstats.merge_scan_conjuncts(per)
    return decisions


def _kernel_filter(root: GroupAgg) -> tuple:
    """The fused kernel consumes its filter directly: the chain must be
    Scan -> Filter(Col <= Lit int) -> GroupAgg.  Returns (col, cutoff)."""
    ops_below = _chain(root)[:-1]  # strip GroupAgg
    if len(ops_below) == 2 and isinstance(ops_below[1], Filter):
        p = ops_below[1].pred
        if (isinstance(p, BinOp) and p.op == "<="
                and isinstance(p.lhs, Col) and isinstance(p.rhs, Lit)
                and isinstance(p.rhs.value, int)):
            return p.lhs.name, int(p.rhs.value)
    raise LoweringError(
        "method='kernel' lowers to the fused filter+aggregate kernel and "
        "requires exactly Scan -> Filter(col <= int) -> GroupAgg"
    )


class _LazyCols(dict):
    """Column view over a (possibly packed-resident) node-stacked table.
    Packed columns decode on first touch and the decoded view is cached,
    so a column whose only consumer is the predicate-on-packed kernel is
    NEVER expanded to raw.  ``raw()`` exposes the undecoded resident
    form."""

    def __getitem__(self, name):
        v = super().__getitem__(name)
        if isinstance(v, PackedColumn):
            v = v.decode()
            super().__setitem__(name, v)
        return v

    def raw(self, name):
        return super().__getitem__(name)


def _col_at(col, idx):
    """Rows ``idx`` (P, k) of a node-stacked column — a code-space gather
    and decode for packed residents (touches k codes, not the column)."""
    if isinstance(col, PackedColumn):
        return col.gather(idx)
    return torch.gather(col, 1, idx)


def _local_index(ctx, table, keys):
    """Node-local row index of each node's keys in ``table``."""
    return keys.to(torch.int64) - ctx.part(table).my_base(ctx.device)


@dataclasses.dataclass
class _Stream:
    base: str          # table whose partitioning the stream follows
    cols: dict         # visible columns, (P, rows) each
    mask: object       # (P, rows) bool tensor or None
    device: torch.device
    overflow: object = False  # bool tensor once an exchange reports one

    def and_mask(self, bits):
        self.mask = bits if self.mask is None else (self.mask & bits)

    @property
    def shape(self) -> tuple:
        """(nodes, rows) of the stream, without decoding anything."""
        return tuple(next(iter(self.cols.values())).shape)


def _measure_stack(aggs, s: _Stream, mask) -> torch.Tensor:
    """(P, rows, len(aggs)) f32 measures, zeroed where ``mask`` is False."""
    outs = []
    for a in aggs:
        if a.agg == "count":
            v = torch.ones(s.shape, dtype=torch.float32, device=s.device)
        else:
            v = eval_expr(a.expr, s.cols).to(torch.float32)
        outs.append(v)
    stacked = torch.stack(outs, dim=-1)
    if mask is not None:
        stacked = torch.where(mask[..., None], stacked, 0.0)
    return stacked


def lower(query: Query, catalog: Catalog, *, wire: str = "packed"):
    """Compile ``query`` into ``plan(ctx, tables)`` (see the module
    docstring for the output).  ``wire`` is the exchange encoding the
    §3.2.2 byte-accurate model assumes ("packed" or "raw"); the plan ships
    packed only where the execution context agrees (``ctx.wire !=
    "raw"``).

    Raises :class:`IRValidationError` for malformed IR and
    :class:`LoweringError` for valid-but-uncompilable queries (min/max
    aggregates, kernel-ineligible shapes, other roots, ``wire="auto"``)."""
    root = query.root
    validate(root, catalog)
    if not isinstance(root, (GroupAgg, TopK)):
        raise LoweringError(
            f"query root must be group_agg or top_k to produce a result set "
            f"(got {type(root).__name__}) — add an aggregation or selection"
        )
    if isinstance(root, GroupAgg):
        bad = [a.name for a in root.aggs if a.agg in ("min", "max")]
        if bad:
            raise LoweringError(
                f"min/max aggregates {bad} are served by rollup cubes only; "
                f"the lowering supports sum/count"
            )
        num_groups = (math.prod(k.cardinality for k in root.keys)
                      if root.keys else 1)
        if root.method == "kernel":
            if num_groups > KERNEL_MAX_GROUPS:
                raise LoweringError(
                    f"{num_groups} groups exceeds the grouped_agg kernel "
                    f"limit {KERNEL_MAX_GROUPS}"
                )
            kernel_col, kernel_cutoff = _kernel_filter(root)

    sj_plans = _decide_semijoins(root, catalog, query_name=query.name,
                                 wire=wire)
    scan_plans = _decide_scans(root, catalog)

    def _eval(node, ctx, t) -> _Stream:
        if isinstance(node, Scan):
            return _Stream(base=node.table, cols=_LazyCols(t[node.table]),
                           mask=None, device=ctx.device)

        s = _eval(node.child, ctx, t)

        if isinstance(node, Filter):
            per = scan_plans.get(id(node))
            if per is None:
                s.and_mask(eval_expr(node.pred, s.cols))
                return s
            acc = None          # AND of per-column bitsets, in word space
            acc_shape = None    # (rows, padded_rows) — same table, so same
            for conjs, ds in per:
                dec = next((d for d in ds if d.mode == "packed"
                            and d.rewrite is not None), None)
                col = (s.cols.raw(dec.rewrite.column)
                       if dec is not None else None)
                if isinstance(col, PackedColumn):
                    # predicate-on-packed: code-space range test over the
                    # resident words, no decode of the column at all
                    words = ops.scan_filter(
                        col.words, dec.rewrite.lo, dec.rewrite.hi,
                        rows=col.rows, padded_rows=col.padded_rows,
                        width=col.width, negate=dec.rewrite.negate)
                    acc = words if acc is None else acc & words
                    acc_shape = (col.rows, col.padded_rows)
                else:
                    for conj in conjs:
                        s.and_mask(eval_expr(conj, s.cols))
            if acc is not None:
                rows, padded = acc_shape
                s.and_mask(compression.unpack_bitset(acc, padded)[:, :rows])
            return s

        if isinstance(node, Project):
            for name, e in node.cols:
                s.cols[name] = eval_expr(e, s.cols)
            return s

        if isinstance(node, SemiJoin):
            sj = sj_plans[id(node)]
            target_cols = _LazyCols(t[node.table])
            part = ctx.part(node.table)
            key = eval_expr(node.key, s.cols)
            if sj.alt == "local":
                bits_owner = eval_expr(node.pred, target_cols)
                s.and_mask(torch.gather(
                    bits_owner, 1, _local_index(ctx, node.table, key)))
            elif sj.alt == "bitset":
                words = semijoin.alt2_bitset(eval_expr(node.pred,
                                                       target_cols))
                s.and_mask(semijoin.probe(words, key, part))
            else:  # request (Alt-1 exchange)
                needed = expr_columns(node.pred)

                def pred_fn(local_idx, m, _cols=target_cols, _p=node.pred,
                            _need=needed):
                    # requested rows only: packed targets gather and
                    # decode the requested codes, not the column
                    view = {c: _col_at(_cols.raw(c), local_idx)
                            for c in _need}
                    return eval_expr(_p, view) & m

                mask = (s.mask if s.mask is not None
                        else torch.ones(key.shape, dtype=torch.bool,
                                        device=key.device))
                bits, ovf = semijoin.alt1_request(
                    key, mask, part, pred_fn,
                    # the derived capacity, unless the context overrides
                    # it under this semi-join's key
                    capacity=ctx.cap(sj.key, sj.capacity),
                    backend=ctx.backend,
                    wire=sj.wire if ctx.wire != "raw" else WireFormat.raw())
                s.and_mask(bits)
                s.overflow = s.overflow | ovf
            return s

        if isinstance(node, Exists):
            inner = _LazyCols(t[node.table])
            bits = eval_expr(node.pred, inner)
            fk_local = _local_index(ctx, s.base, inner[node.key])
            hits = torch.zeros((fk_local.shape[0],
                                ctx.part(s.base).rows_per_node),
                               dtype=torch.int32, device=s.device)
            hits.scatter_add_(1, fk_local, bits.to(torch.int32))
            s.and_mask(hits > 0)
            return s

        if isinstance(node, GroupAggByKey):
            key = eval_expr(node.key, s.cols)
            idx = _local_index(ctx, node.into, key)
            shape = (idx.shape[0], ctx.part(node.into).rows_per_node)
            derived = {}
            for a in node.aggs:
                if a.agg == "count":
                    v = torch.ones(idx.shape, dtype=torch.float32,
                                   device=s.device)
                else:
                    v = eval_expr(a.expr, s.cols).to(torch.float32)
                if s.mask is not None:
                    v = torch.where(s.mask, v, 0.0)
                # float atomics on the card: the order of the sums varies
                # from run to run, and is exact only for integer-valued
                # sums below 2**24 (q18's quantities: at most 7 lines of
                # 1..50 per order)
                derived[a.name] = torch.zeros(
                    shape, dtype=torch.float32,
                    device=s.device).scatter_add_(1, idx, v)
            cols = _LazyCols(t[node.into])
            cols.update(derived)
            return _Stream(base=node.into, cols=cols, mask=None,
                           device=s.device, overflow=s.overflow)

        raise LoweringError(f"cannot lower operator {type(node).__name__}")

    def _group_ids(s: _Stream, *, clip: bool):
        if not root.keys:
            return torch.zeros(s.shape, dtype=torch.int32, device=s.device)
        gid = None
        for k in root.keys:
            code = eval_expr(k.expr, s.cols).to(torch.int32)
            if clip:
                code = torch.clamp(code, 0, k.cardinality - 1)
            gid = code if gid is None else gid * k.cardinality + code
        return gid

    def _group_agg(ctx, t):
        if root.method == "kernel":
            # The kernel applies `pred <= cutoff` itself, so the Filter's
            # scan would be dead: evaluate the Scan below it directly (the
            # JAX package computes that mask and lets XLA drop it; eager
            # PyTorch would really run it).
            s = _eval(root.child.child, ctx, t)
            gid = _group_ids(s, clip=True)  # the kernel indexes by gid
            stacked = _measure_stack(root.aggs, s, mask=None)
            pred = s.cols[kernel_col]
            if pred.is_floating_point():
                raise LoweringError(
                    f"method='kernel' needs an integer filter column, "
                    f"{kernel_col!r} is {pred.dtype}")
            local = ops.filtered_group_sum(
                stacked.contiguous(), gid.contiguous(),
                pred.to(torch.int32).contiguous(),
                cutoff=kernel_cutoff, num_groups=num_groups)
            return {"value": psum(local)}, s

        s = _eval(root.child, ctx, t)
        method = root.method
        if method == "auto":
            method = "onehot" if num_groups <= ONEHOT_MAX_GROUPS else "dense"
        if num_groups == 1:
            # global aggregate: per-measure masked sums, no one-hot detour
            stacked = _measure_stack(root.aggs, s, s.mask)
            local = stacked.sum(dim=1)[:, None, :]
        elif method == "onehot":
            # out-of-range codes match no one-hot row and drop out
            gid = _group_ids(s, clip=False)
            stacked = _measure_stack(root.aggs, s, s.mask)
            local = aggregation.group_sum_onehot(stacked, gid, num_groups)
        else:
            gid = _group_ids(s, clip=True)  # scatter safety
            stacked = _measure_stack(root.aggs, s, s.mask)
            local = torch.stack(
                [aggregation.group_sum_dense(stacked[..., c], gid, num_groups)
                 for c in range(stacked.shape[-1])], dim=-1)
        return {"value": psum(local)}, s

    def _top_k(ctx, t):
        s = _eval(root.child, ctx, t)
        if root.pred is not None:
            s.and_mask(eval_expr(root.pred, s.cols))
        values = eval_expr(root.value, s.cols)
        keys = ctx.part(s.base).global_keys(ctx.device)
        local = topk.local_topk(values, keys, root.k, s.mask)
        # every node's row holds the global winners after the reduction
        winners = topk.TopK(*(a[0] for a in topk.topk_allreduce(local)))
        out = {"values": winners.values, "keys": winners.keys,
               "valid": winners.valid}
        own = [f for f in root.fetch if f.table is None]
        if own:
            # the resident form: packed attributes gather and decode the
            # k winners only
            out.update(late_materialization.materialize(
                winners.keys, winners.valid, ctx.part(s.base),
                {f.name: s.cols.raw(f.name) for f in own}))
        for f in root.fetch:
            if f.table is not None:
                out.update(late_materialization.materialize(
                    out[f.key], winners.valid, ctx.part(f.table),
                    {f.name: t[f.table][f.name]}))
        return out, s

    def plan(ctx, t):
        out, s = (_group_agg if isinstance(root, GroupAgg) else _top_k)(
            ctx, t)
        if s.overflow is not False:
            out["overflow"] = s.overflow
        return out

    plan.params = ()
    # the static semi-join decisions, in chain order
    plan.semijoins = tuple(sj_plans.values())
    # per-column scan strategies (chain order), for EXPLAIN and byte
    # accounting
    plan.scans = tuple(d for per in scan_plans.values()
                       for _, ds in per for d in ds)
    # lowered plans consume packed-resident columns directly (lazy decode,
    # predicate-on-packed, gathers of the fetched rows) — the engine must
    # NOT expand them at entry
    plan.handles_packed = True
    return plan
