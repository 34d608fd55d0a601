"""The §3.2.2 selectivity model, exchange capacities and wire formats, and
compressed residency's code-space predicate rewrite and per-column scan
strategy.

Counterpart of ``repro.query.stats`` for literal predicates.  Exchange
buffers have static shapes, so the expected number of surviving keys
becomes a buffer capacity: the per-destination mean under uniform routing
plus a 6-sigma tail margin and a constant floor, rounded up to a power of
two; the exchange's overflow flag surfaces any under-estimate at run time.

A comparison against a literal rewrites into an inclusive code-range test
``lo <= code <= hi`` (optionally negated) over the packed words —
frame-of-reference columns by integer arithmetic on the offset, dictionary
columns by binary search over the sorted values.  Anything else
(column-vs-column, arithmetic on the column) is evaluated on the decoded
column.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Mapping, Optional

from repro_torch.core import scancal
from repro_torch.core.exchange import WireFormat
from repro_torch.query.ir import (
    BinOp,
    Col,
    ColumnStats,
    Expr,
    LoweringError,
    PackedInfo,
    UnaryOp,
    expr_columns,
    normalize_comparison,
)

# Selinger-style default for predicates the model cannot see through
# (column-vs-column comparisons, opaque expressions).
DEFAULT_SELECTIVITY = 1.0 / 3.0


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def capacity_for(expected: float, *, floor: int = 64) -> int:
    """Static per-destination buffer capacity for an expected message count:
    mean + 6*sqrt(mean) binomial tail margin + constant slack, rounded up
    to a power of two."""
    e = max(float(expected), 0.0)
    need = e + 6.0 * math.sqrt(e) + 16.0
    return next_pow2(max(floor, math.ceil(need)))


def _range_fraction(st: ColumnStats, op: str, v: float) -> float:
    """Fraction of a uniform [lo, hi] domain satisfying ``col op v``."""
    lo, hi = st.lo, st.hi
    if hi <= lo:
        return 1.0
    integral = st.n_distinct > 0
    span = (hi - lo + 1.0) if integral else (hi - lo)
    if op == "<":
        frac = (v - lo) / span
    elif op == "<=":
        frac = (v - lo + (1.0 if integral else 0.0)) / span
    elif op == ">":
        frac = (hi - v) / span
    elif op == ">=":
        frac = (hi - v + (1.0 if integral else 0.0)) / span
    else:
        return DEFAULT_SELECTIVITY
    return min(1.0, max(0.0, frac))


def estimate_selectivity(pred: Expr, stats: Mapping[str, ColumnStats]
                         ) -> float:
    """Estimated fraction of rows satisfying ``pred`` under independence +
    uniformity (the paper's model; good enough to size buffers, and the
    run-time overflow flag catches the rest)."""
    if isinstance(pred, BinOp):
        if pred.op == "and":
            return (estimate_selectivity(pred.lhs, stats)
                    * estimate_selectivity(pred.rhs, stats))
        if pred.op == "or":
            a = estimate_selectivity(pred.lhs, stats)
            b = estimate_selectivity(pred.rhs, stats)
            return min(1.0, a + b - a * b)
        norm = normalize_comparison(pred)
        if norm is not None:
            col, op, v = norm
            st = stats.get(col)
            if st is None:
                return DEFAULT_SELECTIVITY
            if op == "==":
                return (1.0 / st.n_distinct if st.n_distinct
                        else DEFAULT_SELECTIVITY)
            if op == "!=":
                return (1.0 - (1.0 / st.n_distinct) if st.n_distinct
                        else DEFAULT_SELECTIVITY)
            try:
                return _range_fraction(st, op, float(v))
            except (TypeError, ValueError):
                return DEFAULT_SELECTIVITY
        return DEFAULT_SELECTIVITY
    if isinstance(pred, UnaryOp) and pred.op == "not":
        return 1.0 - estimate_selectivity(pred.operand, stats)
    if isinstance(pred, Col):
        # bare boolean column: no histogram, assume an even split
        return 0.5
    return DEFAULT_SELECTIVITY


def request_capacity(table_rows: int, selectivity: float,
                     num_nodes: int) -> int:
    """Capacity for an Alt-1 request exchange: each node ships
    ``rows/P * sel`` keys, spread uniformly over P destinations."""
    n_local = ((table_rows / max(num_nodes, 1))
               * min(max(selectivity, 0.0), 1.0))
    return capacity_for(n_local / max(num_nodes, 1))


def wire_format_for(table_rows: int, num_nodes: int,
                    kind: str = "packed") -> WireFormat:
    """Wire format of an exchange addressing the owners of a table
    range-partitioned over ``num_nodes``: the per-destination key domain
    is ``rows_per_node``.  ``"auto"`` — the JAX package's latency choice
    between packed and raw — needs a wire calibration of the card, which
    the port does not have yet."""
    if kind == "auto":
        raise LoweringError(
            "wire='auto' needs a wire calibration of the card (codec and "
            "link rates), which the port does not have yet; pass "
            "wire='packed' or wire='raw'")
    if kind == "raw":
        return WireFormat.raw()
    if kind != "packed":
        raise LoweringError(f"unknown wire format {kind!r}")
    return WireFormat.packed_for(table_rows, num_nodes)

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _clamp_i32(v: float) -> int:
    return int(min(max(v, _I32_MIN), _I32_MAX))


@dataclasses.dataclass(frozen=True)
class ScanRewrite:
    """A predicate rewritten into code space: the inclusive code range
    ``[lo, hi]`` (empty when ``lo > hi``), optionally negated."""

    column: str
    negate: bool
    describe: str
    lo: int
    hi: int


def _for_bounds(op: str, v, offset: int, maxc: int) -> tuple:
    """Inclusive code bounds of ``x op v`` over FOR codes ``x - offset``."""
    fl, ce = math.floor(v), math.ceil(v)
    if op == "<=":
        return 0, _clamp_i32(fl - offset)
    if op == "<":
        return 0, _clamp_i32(ce - 1 - offset)
    if op == ">=":
        return _clamp_i32(ce - offset), maxc
    if op == ">":
        return _clamp_i32(fl + 1 - offset), maxc
    # == / != : a non-integral value matches nothing (negation of an empty
    # range is everything, which the negate flag handles)
    if fl == v:
        c = _clamp_i32(fl - offset)
        return c, c
    return 0, -1


def _dict_bounds(op: str, v, values: tuple) -> tuple:
    """Inclusive code bounds of ``x op v`` over dictionary positions in
    the sorted ``values``."""
    k = len(values)
    left = bisect.bisect_left(values, v)
    right = bisect.bisect_right(values, v)
    if op == "<=":
        return 0, right - 1
    if op == "<":
        return 0, left - 1
    if op == ">=":
        return left, k - 1
    if op == ">":
        return right, k - 1
    if right > left:  # == / != : present in the dictionary?
        return left, left
    return 0, -1


def scan_rewrite(conjunct: Expr,
                 packed: Mapping[str, PackedInfo]) -> Optional[ScanRewrite]:
    """Rewrite one filter conjunct into a code-space range test over a
    packed column, or None when the shape does not admit it (not a
    ``col op literal`` comparison, or the column is not packed-resident)."""
    norm = normalize_comparison(conjunct)
    if norm is None:
        return None
    col, op, v = norm
    info = packed.get(col)
    if info is None or not isinstance(v, (int, float, bool)):
        return None
    negate = op == "!="
    cmp_op = "==" if negate else op
    if info.values is not None:
        lo, hi = _dict_bounds(cmp_op, v, info.values)
    else:
        lo, hi = _for_bounds(cmp_op, v, info.offset, (1 << info.width) - 1)
    kind = "dict" if info.values is not None else "for"
    return ScanRewrite(column=col, negate=negate,
                       describe=f"{col}{op}{v!r} -> {kind} code range",
                       lo=lo, hi=hi)


@dataclasses.dataclass(frozen=True)
class ScanDecision:
    """Per-(filter conjunct, packed column) scan strategy, decided at
    lower time by the :mod:`repro_torch.core.scancal` roofline."""

    table: str
    column: str
    mode: str                      # 'packed' | 'decode'
    width: int
    rows_per_node: int
    scan_bytes: int                # predicted bytes scanned per node
    raw_bytes: int                 # raw-residency bytes for the same scan
    rewrite: Optional[ScanRewrite] = None
    reason: str = ""


def decide_scan_conjunct(conjunct: Expr, table_name: str,
                         packed: Mapping[str, PackedInfo],
                         rows_per_node: int, *, cal=None) -> list:
    """Scan strategy for one filter conjunct over a packed-resident base
    table: one :class:`ScanDecision` per packed column the conjunct
    touches.  Rewritable predicates go packed iff the roofline says the
    saved bandwidth beats the in-place ALU cost; non-rewritable shapes are
    'decode'."""
    touched = [c for c in sorted(expr_columns(conjunct)) if c in packed]
    if not touched:
        return []
    rewrite = scan_rewrite(conjunct, packed)
    out = []
    for cname in touched:
        info = packed[cname]
        itemsize = 1 if info.dtype == "bool" else 4
        pb = scancal.packed_scan_bytes(rows_per_node, info.width)
        db = scancal.decode_scan_bytes(rows_per_node, info.width, itemsize)
        raw = rows_per_node * itemsize
        if rewrite is not None and rewrite.column == cname:
            mode = scancal.choose_scan_mode(rows_per_node, info.width,
                                            itemsize, cal=cal)
            out.append(ScanDecision(
                table=table_name, column=cname, mode=mode, width=info.width,
                rows_per_node=rows_per_node,
                scan_bytes=pb if mode == "packed" else db, raw_bytes=raw,
                rewrite=rewrite,
                reason=(rewrite.describe if mode == "packed"
                        else "roofline prefers decode")))
        else:
            out.append(ScanDecision(
                table=table_name, column=cname, mode="decode",
                width=info.width, rows_per_node=rows_per_node,
                scan_bytes=db, raw_bytes=raw, rewrite=None,
                reason="predicate not rewritable into code space"))
    return out


def merge_rewrites(a: ScanRewrite, b: ScanRewrite) -> ScanRewrite:
    """Intersect two non-negated code-space range tests over the SAME
    column: ``a AND b`` holds iff the code lies in ``[max(lo_a, lo_b),
    min(hi_a, hi_b)]`` — one kernel scan instead of two."""
    assert a.column == b.column and not a.negate and not b.negate
    return ScanRewrite(column=a.column, negate=False,
                       describe=f"{a.describe} & {b.describe}",
                       lo=max(a.lo, b.lo), hi=min(a.hi, b.hi))


def merge_scan_conjuncts(per: list) -> list:
    """Fuse a filter's same-column range tests into single scans.

    Input: ``[(conjunct, [ScanDecision, ...]), ...]`` per filter.  Output:
    ``[(conjuncts_tuple, [ScanDecision, ...]), ...]`` where entries whose
    decision is a non-negated packed-mode rewrite over the same column
    collapse into one entry with the merged rewrite (bounds intersected).
    Everything else passes through with a 1-tuple of its conjunct."""
    out = []
    by_col = {}
    for conj, ds in per:
        d = ds[0] if len(ds) == 1 else None
        mergeable = (d is not None and d.mode == "packed"
                     and d.rewrite is not None and not d.rewrite.negate)
        if not mergeable:
            out.append(((conj,), ds))
            continue
        i = by_col.get(d.column)
        if i is None:
            by_col[d.column] = len(out)
            out.append(((conj,), ds))
        else:
            conjs0, ds0 = out[i]
            d0 = ds0[0]
            merged = merge_rewrites(d0.rewrite, d.rewrite)
            out[i] = (conjs0 + (conj,), [dataclasses.replace(
                d0, rewrite=merged, reason=merged.describe)])
    return out
