"""Compressed residency: code-space predicate rewrite and per-column scan
strategy.

Counterpart of the scan half of ``repro.query.stats``.  A comparison
against a literal rewrites into an inclusive code-range test ``lo <= code
<= hi`` (optionally negated) over the packed words — frame-of-reference
columns by integer arithmetic on the offset, dictionary columns by binary
search over the sorted values.  Anything else (column-vs-column, arithmetic
on the column) is evaluated on the decoded column.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Mapping, Optional

from repro_torch.core import scancal
from repro_torch.query.ir import (
    Expr,
    PackedInfo,
    expr_columns,
    normalize_comparison,
)

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
