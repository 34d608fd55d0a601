"""The §3.2.2 selectivity model, exchange capacities and wire formats, and
compressed residency's code-space predicate rewrite and per-column scan
strategy.

Counterpart of ``repro.query.stats``.  Exchange buffers have static
shapes, so the expected number of surviving keys becomes a buffer
capacity: the per-destination mean under uniform routing plus a 6-sigma
tail margin and a constant floor, rounded up to a power of two; the
exchange's overflow flag surfaces any under-estimate at run time.  A
parameterized comparison is sized from the prepare-time binding when there
is one, else for the worst binding in the parameter's declared range.

A comparison against a literal or a parameter rewrites into an inclusive
code-range test ``lo <= code <= hi`` (optionally negated) over the packed
words — frame-of-reference columns by integer arithmetic on the offset,
dictionary columns by binary search over the sorted values.  A literal's
bounds are Python ints fixed at lower time; a parameter's are computed at
execute time from its bound value, on the device when the value is a
tensor (0-d, or ``(B,)`` for a batch of lanes), so the bounds never pass
through the host.  Anything else (column-vs-column, arithmetic on the
column) is evaluated on the decoded column.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import scancal
from repro_torch.core.columnar import dictionary
from repro_torch.core.exchange import WireFormat
from repro_torch.query.ir import (
    BinOp,
    Col,
    ColumnStats,
    Expr,
    LoweringError,
    PackedInfo,
    Param,
    UnaryOp,
    UnboundParamError,
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


def estimate_selectivity(pred: Expr, stats: Mapping[str, ColumnStats],
                         binding=None) -> float:
    """Estimated fraction of rows satisfying ``pred`` under independence +
    uniformity (the paper's model; good enough to size buffers, and the
    run-time overflow flag catches the rest).

    A parameterized comparison (``col op Param``) takes its value from
    ``binding`` where it has one, else the WORST binding in the
    parameter's declared ``lo``/``hi`` range (range selectivity is
    monotone in the bound, so the worst case is an endpoint), else 1.0:
    a prepared plan's capacities must hold for every future binding."""
    if isinstance(pred, BinOp):
        if pred.op == "and":
            return (estimate_selectivity(pred.lhs, stats, binding)
                    * estimate_selectivity(pred.rhs, stats, binding))
        if pred.op == "or":
            a = estimate_selectivity(pred.lhs, stats, binding)
            b = estimate_selectivity(pred.rhs, stats, binding)
            return min(1.0, a + b - a * b)
        norm = normalize_comparison(pred)
        if norm is not None:
            col, op, v = norm
            st = stats.get(col)
            if st is None:
                return 1.0 if isinstance(v, Param) else DEFAULT_SELECTIVITY
            if op == "==":
                # value-independent under the distinct-count model, so a
                # parameterized equality needs no binding
                return (1.0 / st.n_distinct if st.n_distinct
                        else DEFAULT_SELECTIVITY)
            if op == "!=":
                return (1.0 - (1.0 / st.n_distinct) if st.n_distinct
                        else DEFAULT_SELECTIVITY)
            if isinstance(v, Param):
                if binding is not None and v.name in binding:
                    v = binding[v.name]
                elif v.lo is not None and v.hi is not None:
                    return max(_range_fraction(st, op, float(v.lo)),
                               _range_fraction(st, op, float(v.hi)))
                else:
                    return 1.0
            try:
                return _range_fraction(st, op, float(v))
            except (TypeError, ValueError):
                return DEFAULT_SELECTIVITY
        return DEFAULT_SELECTIVITY
    if isinstance(pred, UnaryOp) and pred.op == "not":
        return 1.0 - estimate_selectivity(pred.operand, stats, binding)
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
                    kind: str = "packed", *, capacity: int = 0,
                    cal=None) -> WireFormat:
    """Wire format of an exchange addressing the owners of a table
    range-partitioned over ``num_nodes``: the per-destination key domain
    is ``rows_per_node`` and its ``required_width`` fixes the packed key
    width.

    ``kind="auto"`` asks the latency model: packed only where the roofline
    (``core.wirecal``) predicts the byte reduction buys back the codec
    time, i.e. the exchange is network-bound, not codec-bound.  It needs
    the exchange ``capacity``; ``cal`` defaults to the port's saved
    calibration (``wirecal.load()``: the card's where one was measured,
    else the builtin rates)."""
    if kind == "auto":
        from repro_torch.core import wirecal

        wf = WireFormat.packed_for(table_rows, num_nodes)
        kind = wirecal.choose_wire_kind(
            int(capacity), num_nodes, wf.domain,
            cal=cal if cal is not None else wirecal.load())
        return wf if kind == "packed" else WireFormat.raw()
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
    """A predicate rewritten into code space: ``bounds(params)`` yields
    the inclusive code range ``(lo, hi)`` (empty when ``lo > hi``),
    optionally negated — Python ints for a literal predicate, int32
    tensors on the device for a parameter bound to a tensor."""

    column: str
    negate: bool
    describe: str
    bounds: Callable

    def static_bounds(self) -> Optional[tuple]:
        """(lo, hi) of a literal (binding-free) rewrite, else None."""
        try:
            lo, hi = self.bounds(None)
        except LookupError:
            return None
        return lo, hi


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 codes clamped into int32 (the literal path's _clamp_i32)."""
    return x.clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def _pair(lo, hi) -> tuple:
    """Both bounds as Python ints, or both as int32 tensors of one shape
    (a constant bound becomes a tensor on the device, no host copy)."""
    if not isinstance(lo, torch.Tensor) and not isinstance(hi, torch.Tensor):
        return int(lo), int(hi)
    if not isinstance(lo, torch.Tensor):
        lo = torch.full_like(hi, lo, dtype=torch.int32)
    if not isinstance(hi, torch.Tensor):
        hi = torch.full_like(lo, hi, dtype=torch.int32)
    return lo.to(torch.int32), hi.to(torch.int32)


def _scalar(v):
    """A host binding value as a Python scalar (tensors stay)."""
    return v.item() if isinstance(v, np.generic) else v


def _for_bounds(op: str, v, offset: int, maxc: int) -> tuple:
    """Inclusive code bounds of ``x op v`` over FOR codes ``x - offset``.
    ``v`` is a Python scalar, or a tensor (0-d or lanes) whose bounds are
    computed on its device.  Both paths clamp into int32, so a tensor
    gives the literal path's bounds for every value."""
    if not isinstance(v, torch.Tensor):
        fl, ce = math.floor(v), math.ceil(v)
        if op == "<=":
            return 0, _clamp_i32(fl - offset)
        if op == "<":
            return 0, _clamp_i32(ce - 1 - offset)
        if op == ">=":
            return _clamp_i32(ce - offset), maxc
        if op == ">":
            return _clamp_i32(fl + 1 - offset), maxc
        # == / != : a non-integral value matches nothing (negation of an
        # empty range is everything, which the negate flag handles)
        if fl == v:
            c = _clamp_i32(fl - offset)
            return c, c
        return 0, -1
    exact = None
    if v.is_floating_point():
        wide = v.to(torch.float64)
        fl, ce = torch.floor(wide), torch.ceil(wide)
        exact = fl == wide
        fl, ce = (x.clamp(-2.0 ** 62, 2.0 ** 62).to(torch.int64)
                  for x in (fl, ce))
    else:
        fl = ce = v.to(torch.int64)
    if op == "<=":
        return _pair(0, _i32(fl - offset))
    if op == "<":
        return _pair(0, _i32(ce - 1 - offset))
    if op == ">=":
        return _pair(_i32(ce - offset), maxc)
    if op == ">":
        return _pair(_i32(fl + 1 - offset), maxc)
    c = _i32(fl - offset)
    if exact is None:
        return c, c
    return (torch.where(exact, c, 0).to(torch.int32),
            torch.where(exact, c, -1).to(torch.int32))


def _dict_bounds(op: str, v, values: tuple, dtype: str = "float32"
                 ) -> tuple:
    """Inclusive code bounds of ``x op v`` over dictionary positions in
    the sorted ``values``: bisection in float64 for a Python scalar, a
    sorted search in the column's ``dtype`` (float32, as the reference
    searches) on the tensor's device for a tensor."""
    k = len(values)
    if not isinstance(v, torch.Tensor):
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
    va = dictionary(values, dtype, v.device)
    vv = v.to(va.dtype)
    left = torch.searchsorted(va, vv).to(torch.int32)
    right = torch.searchsorted(va, vv, right=True).to(torch.int32)
    if op == "<=":
        return _pair(0, right - 1)
    if op == "<":
        return _pair(0, left - 1)
    if op == ">=":
        return _pair(left, k - 1)
    if op == ">":
        return _pair(right, k - 1)
    found = right > left
    return (torch.where(found, left, 0).to(torch.int32),
            torch.where(found, left, -1).to(torch.int32))


def scan_rewrite(conjunct: Expr,
                 packed: Mapping[str, PackedInfo]) -> Optional[ScanRewrite]:
    """Rewrite one filter conjunct into a code-space range test over a
    packed column, or None when the shape does not admit it (not a
    ``col op scalar`` comparison, or the column is not packed-resident)."""
    norm = normalize_comparison(conjunct)
    if norm is None:
        return None
    col, op, v = norm
    info = packed.get(col)
    if info is None:
        return None
    negate = op == "!="
    cmp_op = "==" if negate else op
    maxc = (1 << info.width) - 1

    def code_bounds(x):
        if info.values is not None:
            return _dict_bounds(cmp_op, x, info.values, info.dtype)
        return _for_bounds(cmp_op, x, info.offset, maxc)

    if isinstance(v, Param):
        param = v

        def bounds(params):
            if params is None or param.name not in params:
                raise UnboundParamError(
                    f"parameter {param.name!r} has no binding")
            return code_bounds(_scalar(params[param.name]))

        vs = f"${param.name}"
    else:
        if not isinstance(v, (int, float, bool)):
            return None
        lo, hi = code_bounds(v)

        def bounds(params, _lo=lo, _hi=hi):
            return _lo, _hi

        vs = repr(v)
    kind = "dict" if info.values is not None else "for"
    return ScanRewrite(column=col, negate=negate,
                       describe=f"{col}{op}{vs} -> {kind} code range",
                       bounds=bounds)


@dataclasses.dataclass(frozen=True)
class ScanDecision:
    """Per-(filter conjunct, packed column) scan strategy, decided at
    lower time by the :mod:`repro_torch.core.scancal` roofline and
    rendered by EXPLAIN."""

    table: str
    column: str
    mode: str                      # 'packed' | 'decode'
    width: int
    rows_per_node: int
    scan_bytes: int                # predicted bytes scanned per node
    raw_bytes: int                 # raw-residency bytes for the same scan
    rewrite: Optional[ScanRewrite] = None
    reason: str = ""

    @property
    def rewritable(self) -> bool:
        return self.rewrite is not None


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


def _bound_max(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return a.clamp(min=b)
    return b.clamp(min=a) if isinstance(b, torch.Tensor) else max(a, b)


def _bound_min(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return a.clamp(max=b)
    return b.clamp(max=a) if isinstance(b, torch.Tensor) else min(a, b)


def merge_rewrites(a: ScanRewrite, b: ScanRewrite) -> ScanRewrite:
    """Intersect two non-negated code-space range tests over the SAME
    column: ``a AND b`` holds iff the code lies in ``[max(lo_a, lo_b),
    min(hi_a, hi_b)]`` — one kernel scan instead of two.  Tensor bounds
    intersect on the device."""
    assert a.column == b.column and not a.negate and not b.negate

    def bounds(params, _a=a, _b=b):
        lo1, hi1 = _a.bounds(params)
        lo2, hi2 = _b.bounds(params)
        return _pair(_bound_max(lo1, lo2), _bound_min(hi1, hi2))

    return ScanRewrite(column=a.column, negate=False,
                       describe=f"{a.describe} & {b.describe}",
                       bounds=bounds)


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
