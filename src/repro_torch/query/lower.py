"""Lowering pass: logical IR -> physical node-stacked plan.

Counterpart of ``repro.query.lower`` for Scan/Filter/Project/GroupAgg.
``lower(query, catalog)`` compiles an IR tree into a plan function with the
engine's signature ``plan(ctx, tables)``; ``Cluster.compile`` binds it.
Every tensor in the plan carries the leading node axis, so the plan body
runs once for all P nodes and merges per-node partials with one ``psum``.

Physical mapping:

- ``Filter``  -> each conjunct over a packed column is rewritten into a
  code-space range test and evaluated on the packed words by the scan
  kernel (``kernels.ops.scan_filter``); same-column tests fuse into one
  scan, the scans AND in word space, and ONE bitset unpack yields the row
  mask.  Other conjuncts run on the decoded columns.
- ``Project`` -> vectorized column ops.
- ``GroupAgg`` -> per-measure masked sums (one group), a one-hot matmul
  (``onehot``), a dense scatter-add (``dense``), or the fused
  filter + grouped-aggregation kernel (``kernel``,
  ``kernels.ops.filtered_group_sum``), then ``psum``.

Packed columns decode on first touch only (:class:`_LazyCols`): a column
read only by the scan kernel is never expanded.

Lowered plans return ``{"value": (groups, aggs) f32 tensor}``.  Min/max
aggregates, other operators and other roots raise :class:`LoweringError`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import aggregation, compression, scancal
from repro_torch.core.columnar import PackedColumn
from repro_torch.core.engine import psum
from repro_torch.kernels import ops
from repro_torch.query import stats as qstats
from repro_torch.query.ir import (
    BinOp,
    Catalog,
    Col,
    Filter,
    GroupAgg,
    Lit,
    LoweringError,
    Project,
    Query,
    Scan,
    conjuncts,
    eval_expr,
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


@dataclasses.dataclass
class _Stream:
    base: str          # table whose partitioning the stream follows
    cols: dict         # visible columns, (P, rows) each
    mask: object       # (P, rows) bool tensor or None
    device: torch.device

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


def lower(query: Query, catalog: Catalog):
    """Compile ``query`` into ``plan(ctx, tables)`` returning
    ``{"value": (groups, aggs) tensor}``.

    Raises :class:`IRValidationError` for malformed IR and
    :class:`LoweringError` for valid-but-uncompilable queries (min/max
    aggregates, kernel-ineligible shapes, non-GroupAgg roots)."""
    root = query.root
    validate(root, catalog)
    if not isinstance(root, GroupAgg):
        raise LoweringError(
            f"query root must be group_agg to produce a result set (got "
            f"{type(root).__name__}); other roots are not yet ported"
        )
    bad = [a.name for a in root.aggs if a.agg in ("min", "max")]
    if bad:
        raise LoweringError(
            f"min/max aggregates {bad} are served by rollup cubes only; the "
            f"lowering supports sum/count"
        )
    num_groups = math.prod(k.cardinality for k in root.keys) if root.keys else 1
    if root.method == "kernel":
        if num_groups > KERNEL_MAX_GROUPS:
            raise LoweringError(
                f"{num_groups} groups exceeds the grouped_agg kernel "
                f"limit {KERNEL_MAX_GROUPS}"
            )
        kernel_col, kernel_cutoff = _kernel_filter(root)

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

        raise LoweringError(f"cannot lower operator {type(node).__name__} "
                            f"(not yet ported)")

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

    def plan(ctx, t):
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
            return {"value": psum(local)}

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
        return {"value": psum(local)}

    plan.params = ()
    # per-column scan strategies (chain order), for EXPLAIN and byte
    # accounting
    plan.scans = tuple(d for per in scan_plans.values()
                       for _, ds in per for d in ds)
    # lowered plans consume packed-resident columns directly (lazy decode,
    # predicate-on-packed) — the engine must NOT expand them at entry
    plan.handles_packed = True
    return plan
