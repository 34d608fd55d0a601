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

Prepared plans.  A query with :class:`~repro_torch.query.ir.Param`
placeholders lowers to ``plan(ctx, tables, params)``, ``params`` mapping
each name to a 0-d tensor on the device: the scan bounds are computed
from them on the device (``ScanRewrite.bounds``), so one lowered plan
serves every binding and a captured run replays for new values written
into the same tensors.

Batched plans (``batched=True``) take each parameter as a ``(B,)`` tensor,
one value a lane, and give every output a leading lane axis — an explicit
lane axis, not ``torch.vmap`` (the plans scatter and index-update).  Each
packed scan runs ONCE for all lanes: the scan kernel reads the lanes'
``(B, 2)`` code bounds from device memory and writes ``(B, P, words)``
bitsets.  A ``method="auto"`` GroupAgg whose group codes and measures are
parameter-free (:func:`_maskgemm_eligible`) then contracts the ``(B, n)``
lane masks against the ``(n, G*M)`` one-hot (x) measures, one batched
product per node.  Everything else — other conjuncts, semi-joins, other
aggregations — runs lane by lane on the lane's own masks with the scalar
plan's own operations, so a lane's answer is byte-equal to the scalar
execute of its binding.  A request semi-join in particular makes one
exchange a lane, with that lane's own buckets, capacity and overflow
flag: one lane that overflows leaves its siblings whole.  Decoded columns
are shared by the lanes of one run.
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
    Bin,
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
    UnaryOp,
    conjuncts,
    eval_expr,
    expr_columns,
    expr_params,
    query_params,
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
                      wire: str = "packed", binding=None) -> dict:
    """Each SemiJoin's physical alternative and buffer capacity from the
    §3.2.2 model, with selectivities accumulated along the chain.  The
    choice is byte-accurate: the static wire bytes of the Alt-1 exchange at
    its derived capacity and packed widths under ``wire``, against the
    Alt-2 bitset allgather.  ``binding`` resolves parameterized predicates
    for the estimates; an unbound parameter is sized for the worst binding
    in its declared range (``query.stats.estimate_selectivity``)."""
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
            sel *= qstats.estimate_selectivity(node.pred, tinfo.stats,
                                               binding)
        elif isinstance(node, Exists):
            sel *= qstats.DEFAULT_SELECTIVITY
        elif isinstance(node, GroupAggByKey):
            base = node.into
            sel = 1.0
        elif isinstance(node, SemiJoin):
            target = catalog.table(node.table)
            gamma = qstats.estimate_selectivity(node.pred, target.stats,
                                                binding)
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


def _has_division(e) -> bool:
    """Whether an expression can turn finite inputs non-finite (division).
    It gates the batched mask product: that product folds the lane mask in
    AFTER the measures are evaluated, and 0 * inf = NaN would poison a
    group sum that the masked per-lane path computes correctly."""
    if isinstance(e, BinOp):
        return e.op == "/" or _has_division(e.lhs) or _has_division(e.rhs)
    if isinstance(e, UnaryOp):
        return _has_division(e.operand)
    if isinstance(e, Bin):
        return _has_division(e.child)
    return False


def _maskgemm_eligible(root: GroupAgg, num_groups: int) -> bool:
    """The batched ``mask @ (onehot (x) measures)`` product requires the
    expanded tensor to be parameter-free (one tensor for every lane),
    bounded (one-hot-sized group spaces only) and NaN-safe (no division
    feeding group codes or measures: the lane mask is folded in by
    multiplication, after evaluation)."""
    if not 1 < num_groups <= ONEHOT_MAX_GROUPS:
        return False
    exprs = [k.expr for k in root.keys]
    exprs += [a.expr for a in root.aggs if a.expr is not None]
    # projections below the root may feed group keys and measures
    for node in _chain(root)[:-1]:
        if isinstance(node, Project):
            exprs += [e for _, e in node.cols]
    return not any(expr_params(e) or _has_division(e) for e in exprs)


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
    Packed columns decode on first touch and the decoded view is cached
    (in ``cache``, which the lanes of a batched run share), so a column
    whose only consumer is the predicate-on-packed kernel is NEVER
    expanded to raw.  ``raw()`` exposes the undecoded resident form."""

    def __init__(self, columns, cache=None):
        super().__init__(columns)
        self._decoded = {} if cache is None else cache

    def __getitem__(self, name):
        v = super().__getitem__(name)
        if isinstance(v, PackedColumn):
            d = self._decoded.get(id(v))
            if d is None:
                d = self._decoded[id(v)] = v.decode()
            super().__setitem__(name, d)
            v = d
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


def _measure_stack(aggs, s: _Stream, mask, pv) -> torch.Tensor:
    """(P, rows, len(aggs)) f32 measures, zeroed where ``mask`` is False."""
    outs = []
    for a in aggs:
        if a.agg == "count":
            v = torch.ones(s.shape, dtype=torch.float32, device=s.device)
        else:
            v = eval_expr(a.expr, s.cols, pv).to(torch.float32)
        outs.append(v)
    stacked = torch.stack(outs, dim=-1)
    if mask is not None:
        stacked = torch.where(mask[..., None], stacked, 0.0)
    return stacked


def _lanes(pv) -> int:
    """The lane count B of a batched run's ``(B,)`` parameter tensors."""
    shapes = {tuple(v.shape) for v in pv.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 1:
        raise ValueError(f"a batched plan takes every parameter as one "
                         f"(B,) tensor, got shapes {sorted(shapes)}")
    return next(iter(shapes))[0]


def lower(query: Query, catalog: Catalog, *, wire: str = "packed",
          binding=None, batched: bool = False, obs=None):
    """Compile ``query`` into ``plan(ctx, tables)``, or ``plan(ctx, tables,
    params)`` where the query has parameters (see the module docstring for
    both, and for ``batched``).  ``wire`` is the exchange encoding the
    §3.2.2 byte-accurate model assumes ("packed" or "raw"); the plan ships
    packed only where the execution context agrees (``ctx.wire !=
    "raw"``).  ``binding`` feeds only the static capacity and alternative
    decisions, never the values the plan computes with: pass the
    prepare-time defaults of an auto-parameterized literal query to size
    its buffers as the literal plan would.  The plan's parameter
    signature is ``plan.params``.

    ``obs`` (an :class:`repro_torch.obs.Observer`) records the lowering's
    decisions as a trace event.

    Raises :class:`IRValidationError` for malformed IR and
    :class:`LoweringError` for valid-but-uncompilable queries (min/max
    aggregates, kernel-ineligible shapes, other roots, ``wire="auto"``)."""
    root = query.root
    validate(root, catalog)
    params = query_params(root)
    if not isinstance(root, (GroupAgg, TopK)):
        raise LoweringError(
            f"query root must be group_agg or top_k to produce a result set "
            f"(got {type(root).__name__}) — add an aggregation or selection"
        )
    maskgemm = False
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
        maskgemm = (batched and root.method == "auto"
                    and _maskgemm_eligible(root, num_groups))

    sj_plans = _decide_semijoins(root, catalog, query_name=query.name,
                                 wire=wire, binding=binding)
    scan_plans = _decide_scans(root, catalog)
    if obs is not None:
        obs.event(
            "lower", cat="plan",
            query=query.name or "<lowered-ir>", batched=batched, wire=wire,
            n_params=len(params),
            semijoins=" ".join(f"{d.key}:{d.alt}" for d in sj_plans.values())
            or "none",
        )

    def _eval(node, ctx, t, pv, scan, cache) -> _Stream:
        if isinstance(node, Scan):
            return _Stream(base=node.table,
                           cols=_LazyCols(t[node.table], cache),
                           mask=None, device=ctx.device)

        s = _eval(node.child, ctx, t, pv, scan, cache)

        if isinstance(node, Filter):
            per = scan_plans.get(id(node))
            if per is None:
                s.and_mask(eval_expr(node.pred, s.cols, pv))
                return s
            acc = None          # AND of per-column bitsets, in word space
            acc_shape = None    # (rows, padded_rows) — same table, so same
            for i, (conjs, ds) in enumerate(per):
                dec = next((d for d in ds if d.mode == "packed"
                            and d.rewrite is not None), None)
                col = (s.cols.raw(dec.rewrite.column)
                       if dec is not None else None)
                if isinstance(col, PackedColumn):
                    # predicate-on-packed: code-space range test over the
                    # resident words, no decode of the column at all
                    words = scan((id(node), i), dec, col)
                    acc = words if acc is None else acc & words
                    acc_shape = (col.rows, col.padded_rows)
                else:
                    for conj in conjs:
                        s.and_mask(eval_expr(conj, s.cols, pv))
            if acc is not None:
                rows, padded = acc_shape
                s.and_mask(compression.unpack_bitset(acc, padded)[:, :rows])
            return s

        if isinstance(node, Project):
            for name, e in node.cols:
                s.cols[name] = eval_expr(e, s.cols, pv)
            return s

        if isinstance(node, SemiJoin):
            sj = sj_plans[id(node)]
            target_cols = _LazyCols(t[node.table], cache)
            part = ctx.part(node.table)
            key = eval_expr(node.key, s.cols, pv)
            if sj.alt == "local":
                bits_owner = eval_expr(node.pred, target_cols, pv)
                s.and_mask(torch.gather(
                    bits_owner, 1, _local_index(ctx, node.table, key)))
            elif sj.alt == "bitset":
                words = semijoin.alt2_bitset(eval_expr(node.pred,
                                                       target_cols, pv))
                s.and_mask(semijoin.probe(words, key, part))
            else:  # request (Alt-1 exchange)
                needed = expr_columns(node.pred)

                def pred_fn(local_idx, m, _cols=target_cols, _p=node.pred,
                            _need=needed, _pv=pv):
                    # requested rows only: packed targets gather and
                    # decode the requested codes, not the column
                    view = {c: _col_at(_cols.raw(c), local_idx)
                            for c in _need}
                    return eval_expr(_p, view, _pv) & m

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
            inner = _LazyCols(t[node.table], cache)
            bits = eval_expr(node.pred, inner, pv)
            fk_local = _local_index(ctx, s.base, inner[node.key])
            hits = torch.zeros((fk_local.shape[0],
                                ctx.part(s.base).rows_per_node),
                               dtype=torch.int32, device=s.device)
            hits.scatter_add_(1, fk_local, bits.to(torch.int32))
            s.and_mask(hits > 0)
            return s

        if isinstance(node, GroupAggByKey):
            key = eval_expr(node.key, s.cols, pv)
            idx = _local_index(ctx, node.into, key)
            shape = (idx.shape[0], ctx.part(node.into).rows_per_node)
            derived = {}
            for a in node.aggs:
                if a.agg == "count":
                    v = torch.ones(idx.shape, dtype=torch.float32,
                                   device=s.device)
                else:
                    v = eval_expr(a.expr, s.cols, pv).to(torch.float32)
                if s.mask is not None:
                    v = torch.where(s.mask, v, 0.0)
                # float atomics on the card: the order of the sums varies
                # from run to run, and is exact only for integer-valued
                # sums below 2**24 (q18's quantities: at most 7 lines of
                # 1..50 per order)
                derived[a.name] = torch.zeros(
                    shape, dtype=torch.float32,
                    device=s.device).scatter_add_(1, idx, v)
            cols = _LazyCols(t[node.into], cache)
            cols.update(derived)
            return _Stream(base=node.into, cols=cols, mask=None,
                           device=s.device, overflow=s.overflow)

        raise LoweringError(f"cannot lower operator {type(node).__name__}")

    def _group_ids(s: _Stream, pv, *, clip: bool):
        if not root.keys:
            return torch.zeros(s.shape, dtype=torch.int32, device=s.device)
        gid = None
        for k in root.keys:
            code = eval_expr(k.expr, s.cols, pv).to(torch.int32)
            if clip:
                code = torch.clamp(code, 0, k.cardinality - 1)
            gid = code if gid is None else gid * k.cardinality + code
        return gid

    def _group_agg(ctx, t, pv, scan, cache):
        if root.method == "kernel":
            # The kernel applies `pred <= cutoff` itself, so the Filter's
            # scan would be dead: evaluate the Scan below it directly (the
            # JAX package computes that mask and lets XLA drop it; eager
            # PyTorch would really run it).
            s = _eval(root.child.child, ctx, t, pv, scan, cache)
            gid = _group_ids(s, pv, clip=True)  # the kernel indexes by gid
            stacked = _measure_stack(root.aggs, s, None, pv)
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

        s = _eval(root.child, ctx, t, pv, scan, cache)
        method = root.method
        if method == "auto":
            method = "onehot" if num_groups <= ONEHOT_MAX_GROUPS else "dense"
        if num_groups == 1:
            # global aggregate: per-measure masked sums, no one-hot detour
            stacked = _measure_stack(root.aggs, s, s.mask, pv)
            local = stacked.sum(dim=1)[:, None, :]
        elif method == "onehot":
            # out-of-range codes match no one-hot row and drop out
            gid = _group_ids(s, pv, clip=False)
            stacked = _measure_stack(root.aggs, s, s.mask, pv)
            local = aggregation.group_sum_onehot(stacked, gid, num_groups)
        else:
            gid = _group_ids(s, pv, clip=True)  # scatter safety
            stacked = _measure_stack(root.aggs, s, s.mask, pv)
            local = torch.stack(
                [aggregation.group_sum_dense(stacked[..., c], gid, num_groups)
                 for c in range(stacked.shape[-1])], dim=-1)
        return {"value": psum(local)}, s

    def _top_k(ctx, t, pv, scan, cache):
        s = _eval(root.child, ctx, t, pv, scan, cache)
        if root.pred is not None:
            s.and_mask(eval_expr(root.pred, s.cols, pv))
        values = eval_expr(root.value, s.cols, pv)
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

    body = _group_agg if isinstance(root, GroupAgg) else _top_k

    def scan_with(pv):
        """The packed scans under parameters ``pv``: one kernel launch
        each, with a lane axis where the bounds have one."""
        def scan(key, dec, col):
            lo, hi = dec.rewrite.bounds(pv)
            return ops.scan_filter(col.words, lo, hi, rows=col.rows,
                                   padded_rows=col.padded_rows,
                                   width=col.width,
                                   negate=dec.rewrite.negate)
        return scan

    def run(ctx, t, pv):
        out, s = body(ctx, t, pv, scan_with(pv), {})
        if s.overflow is not False:
            out["overflow"] = s.overflow
        return out

    def lane_scan(pv, lane, done):
        """Lane ``lane``'s bitset of a scan that runs once for all lanes
        (on the first lane that reaches it); a scan whose bounds are
        literal has no lane axis."""
        batch = scan_with(pv)

        def scan(key, dec, col):
            if key not in done:
                done[key] = batch(key, dec, col)
            words = done[key]
            return words[lane] if words.ndim == 3 else words
        return scan

    def run_batched(ctx, t, pv):
        B = _lanes(pv)
        lane_pv = [{k: v[b] for k, v in pv.items()} for b in range(B)]
        done, cache = {}, {}
        if maskgemm:
            streams = [_eval(root.child, ctx, t, lane_pv[b],
                             lane_scan(pv, b, done), cache)
                       for b in range(B)]
            s = streams[0]
            # group codes and measures are parameter-free, only the mask
            # varies by lane: contract the lane masks against the
            # (n, G*M) one-hot (x) measures once.  Out-of-range codes match
            # no one-hot column and drop out, as in the onehot path
            gid = _group_ids(s, lane_pv[0], clip=False)
            stacked = _measure_stack(root.aggs, s, None, lane_pv[0])
            P, n, m = stacked.shape
            ids = torch.arange(num_groups, dtype=torch.int32,
                               device=s.device)
            onehot = (gid[..., None] == ids).to(torch.float32)
            expanded = (onehot[..., None] * stacked[..., None, :]).reshape(
                P, n, num_groups * m)
            del onehot, stacked
            masks = torch.stack(
                [x.mask if x.mask is not None
                 else torch.ones((P, n), dtype=torch.bool, device=s.device)
                 for x in streams], dim=1)
            local = torch.bmm(masks.to(torch.float32), expanded)
            out = {"value": psum(local).reshape(B, num_groups, m)}
            if s.overflow is not False:
                out["overflow"] = torch.stack([x.overflow for x in streams])
            return out
        outs = []
        for b in range(B):
            out, s = body(ctx, t, lane_pv[b], lane_scan(pv, b, done), cache)
            if s.overflow is not False:
                out["overflow"] = s.overflow
            outs.append(out)
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    if batched:
        plan = run_batched
    elif params:
        plan = run
    else:
        def plan(ctx, t):
            return run(ctx, t, None)
    plan.params = params
    plan.batched = batched
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
