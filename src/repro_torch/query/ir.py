"""Declarative query IR: expressions, operators, catalog, validation.

Counterpart of ``repro.query.ir``: the operators ``Scan``, ``Filter``,
``Project``, ``SemiJoin``, ``Exists``, ``GroupAgg``, ``GroupAggByKey`` and
``TopK`` (with ``Fetch`` attributes) over expression trees of columns,
literals, runtime parameters (``Param``, bound at execute time: the
paper's §2/§3.1 compile-once model) and binned keys (``Bin``).

Precedence gotcha: ``&``/``|`` bind tighter than comparisons in Python —
always parenthesize comparisons inside conjunctions:
``(C("a") >= lo) & (C("a") < hi)``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------


class QueryError(Exception):
    """Base class for all query-IR errors."""


class UnknownPlanError(QueryError, LookupError):
    """A plan/query name is not in the registry."""


class IRValidationError(QueryError):
    """The IR tree is malformed w.r.t. the catalog (unbound column,
    unknown table, ...)."""


class LoweringError(QueryError):
    """The IR is valid but not compilable (min/max aggregates, kernel
    shape mismatch, an operator not yet ported)."""


class UnboundParamError(QueryError, LookupError):
    """A :class:`Param` placeholder was evaluated without a binding for
    its name (execute a prepared query with the missing parameter)."""


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


class Expr:
    """Base expression node.  Operators build trees; ``==`` builds a
    predicate."""

    def __add__(self, other):
        return BinOp("+", self, _wrap(other))

    def __radd__(self, other):
        return BinOp("+", _wrap(other), self)

    def __sub__(self, other):
        return BinOp("-", self, _wrap(other))

    def __rsub__(self, other):
        return BinOp("-", _wrap(other), self)

    def __mul__(self, other):
        return BinOp("*", self, _wrap(other))

    def __rmul__(self, other):
        return BinOp("*", _wrap(other), self)

    def __truediv__(self, other):
        return BinOp("/", self, _wrap(other))

    def __neg__(self):
        return UnaryOp("neg", self)

    def __eq__(self, other):  # noqa: D105 — builds a predicate
        return BinOp("==", self, _wrap(other))

    def __ne__(self, other):
        return BinOp("!=", self, _wrap(other))

    def __lt__(self, other):
        return BinOp("<", self, _wrap(other))

    def __le__(self, other):
        return BinOp("<=", self, _wrap(other))

    def __gt__(self, other):
        return BinOp(">", self, _wrap(other))

    def __ge__(self, other):
        return BinOp(">=", self, _wrap(other))

    def __and__(self, other):
        return BinOp("and", self, _wrap(other))

    def __or__(self, other):
        return BinOp("or", self, _wrap(other))

    def __invert__(self):
        return UnaryOp("not", self)

    __hash__ = object.__hash__


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    """Reference to a column of the current stream."""

    name: str


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: object


@dataclasses.dataclass(frozen=True, eq=False)
class Param(Expr):
    """Runtime query parameter: a scalar placeholder bound at execute
    time, so ONE lowered plan serves every literal binding.

    ``lo``/``hi`` optionally declare the binding range; the selectivity
    model sizes exchange buffer capacities for the WORST binding in the
    declared range (no range -> fully conservative).  The range is a
    sizing hint, not a runtime check."""

    name: str
    dtype: str = "float32"  # numpy dtype name of the bound scalar
    lo: Optional[float] = None
    hi: Optional[float] = None

    def __post_init__(self):
        np.dtype(self.dtype)  # typo-proof: fail at build, not at bind


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str  # + - * / == != < <= > >= and or
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True, eq=False)
class UnaryOp(Expr):
    op: str  # not neg
    operand: Expr


@dataclasses.dataclass(frozen=True, eq=False)
class Bin(Expr):
    """Digitize a numeric expression against sorted ``edges``: code ``j``
    covers the half-open interval ``(edges[j-1], edges[j]]`` (the cube's
    convention for binned dimensions)."""

    child: Expr
    edges: tuple

    def __post_init__(self):
        object.__setattr__(self, "edges", tuple(sorted(self.edges)))

    @property
    def cardinality(self) -> int:
        return len(self.edges) + 1


C = Col  # builder shorthand: C("l_shipdate") <= cutoff


_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
}


def _digitize(col, edges: tuple):
    """Bin codes of ``col``: the number of edges strictly below each value
    (numpy's ``searchsorted(side="left")``), as int32."""
    if isinstance(col, torch.Tensor):
        e = torch.as_tensor(np.asarray(edges), device=col.device)
        e = e.to(col.dtype)
        return torch.searchsorted(e, col.contiguous()).to(torch.int32)
    col = np.asarray(col)
    return np.searchsorted(np.asarray(edges, col.dtype), col,
                           side="left").astype(np.int32)


def eval_expr(e: Expr, cols: Mapping[str, object], params=None):
    """Evaluate an expression against a column dict (torch tensors inside a
    plan, numpy on the host — both work: only python operators and a
    sorted search).  ``params`` binds :class:`Param` placeholders by name
    (0-d tensors on the device inside a prepared plan, python or numpy
    scalars on the host)."""
    if isinstance(e, Col):
        return cols[e.name]
    if isinstance(e, Lit):
        return e.value
    if isinstance(e, Param):
        if params is None or e.name not in params:
            raise UnboundParamError(
                f"parameter {e.name!r} has no binding — pass it via "
                f"params= (bound: {sorted(params) if params else 'none'})")
        return params[e.name]
    if isinstance(e, BinOp):
        return _BINOPS[e.op](eval_expr(e.lhs, cols, params),
                             eval_expr(e.rhs, cols, params))
    if isinstance(e, UnaryOp):
        v = eval_expr(e.operand, cols, params)
        return ~v if e.op == "not" else -v
    if isinstance(e, Bin):
        return _digitize(eval_expr(e.child, cols, params), e.edges)
    raise IRValidationError(f"unknown expression node {type(e).__name__}")


def expr_columns(e: Expr) -> frozenset:
    """Set of column names an expression reads."""
    if isinstance(e, Col):
        return frozenset((e.name,))
    if isinstance(e, (Lit, Param)):
        return frozenset()
    if isinstance(e, BinOp):
        return expr_columns(e.lhs) | expr_columns(e.rhs)
    if isinstance(e, UnaryOp):
        return expr_columns(e.operand)
    if isinstance(e, Bin):
        return expr_columns(e.child)
    raise IRValidationError(f"unknown expression node {type(e).__name__}")


def expr_params(e: Optional[Expr]) -> tuple:
    """Params an expression binds, in deterministic pre-order (duplicates
    by name kept once, first occurrence wins)."""
    if e is None or isinstance(e, (Col, Lit)):
        return ()
    if isinstance(e, Param):
        return (e,)
    if isinstance(e, BinOp):
        return _dedup_params(expr_params(e.lhs) + expr_params(e.rhs))
    if isinstance(e, UnaryOp):
        return expr_params(e.operand)
    if isinstance(e, Bin):
        return expr_params(e.child)
    raise IRValidationError(f"unknown expression node {type(e).__name__}")


def _dedup_params(ps: tuple) -> tuple:
    out, seen = [], {}
    for p in ps:
        prev = seen.get(p.name)
        if prev is None:
            seen[p.name] = p
            out.append(p)
        elif not same_expr(prev, p):
            raise IRValidationError(
                f"parameter {p.name!r} declared twice with different "
                f"dtype/range ({prev.dtype}/[{prev.lo},{prev.hi}] vs "
                f"{p.dtype}/[{p.lo},{p.hi}])")
    return tuple(out)


def same_expr(a: Optional[Expr], b: Optional[Expr]) -> bool:
    """Structural equality (``==`` on Expr builds a predicate instead)."""
    if a is None or b is None:
        return a is b
    if type(a) is not type(b):
        return False
    if isinstance(a, Col):
        return a.name == b.name
    if isinstance(a, Lit):
        return a.value == b.value
    if isinstance(a, Param):
        return (a.name == b.name and a.dtype == b.dtype
                and a.lo == b.lo and a.hi == b.hi)
    if isinstance(a, BinOp):
        return (a.op == b.op and same_expr(a.lhs, b.lhs)
                and same_expr(a.rhs, b.rhs))
    if isinstance(a, UnaryOp):
        return a.op == b.op and same_expr(a.operand, b.operand)
    if isinstance(a, Bin):
        return a.edges == b.edges and same_expr(a.child, b.child)
    return False


_FLIP_CMP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
             "==": "==", "!=": "!="}


def normalize_comparison(e: Expr) -> Optional[tuple]:
    """``Col op Lit`` / ``Col op Param`` (either side) -> (column, op,
    value), with the operator flipped when the scalar is on the left; None
    for anything else.  For a literal ``value`` is the raw python value,
    for a parameter the :class:`Param` node itself."""
    if not isinstance(e, BinOp) or e.op not in _FLIP_CMP:
        return None

    def _scalar(x):
        return x.value if isinstance(x, Lit) else x

    if isinstance(e.lhs, Col) and isinstance(e.rhs, (Lit, Param)):
        return e.lhs.name, e.op, _scalar(e.rhs)
    if isinstance(e.lhs, (Lit, Param)) and isinstance(e.rhs, Col):
        return e.rhs.name, _FLIP_CMP[e.op], _scalar(e.lhs)
    return None


def same_node(a, b) -> bool:
    """Structural equality of operator trees (``Expr.__eq__`` builds
    predicates, so dataclass equality is unavailable by design)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, Scan):
        return a.table == b.table
    if isinstance(a, Filter):
        return same_expr(a.pred, b.pred) and same_node(a.child, b.child)
    if isinstance(a, Project):
        return (len(a.cols) == len(b.cols)
                and all(n1 == n2 and same_expr(e1, e2)
                        for (n1, e1), (n2, e2) in zip(a.cols, b.cols))
                and same_node(a.child, b.child))
    if isinstance(a, SemiJoin):
        return (a.table == b.table and a.alt == b.alt
                and same_expr(a.key, b.key) and same_expr(a.pred, b.pred)
                and same_node(a.child, b.child))
    if isinstance(a, Exists):
        return (a.table == b.table and a.key == b.key
                and same_expr(a.pred, b.pred) and same_node(a.child, b.child))
    if isinstance(a, GroupAgg):
        return (a.method == b.method
                and len(a.keys) == len(b.keys) and len(a.aggs) == len(b.aggs)
                and all(k1.name == k2.name and k1.cardinality == k2.cardinality
                        and same_expr(k1.expr, k2.expr)
                        for k1, k2 in zip(a.keys, b.keys))
                and all(g1.name == g2.name and g1.agg == g2.agg
                        and same_expr(g1.expr, g2.expr)
                        for g1, g2 in zip(a.aggs, b.aggs))
                and same_node(a.child, b.child))
    if isinstance(a, GroupAggByKey):
        return (a.into == b.into and same_expr(a.key, b.key)
                and len(a.aggs) == len(b.aggs)
                and all(g1.name == g2.name and g1.agg == g2.agg
                        and same_expr(g1.expr, g2.expr)
                        for g1, g2 in zip(a.aggs, b.aggs))
                and same_node(a.child, b.child))
    if isinstance(a, TopK):
        return (a.k == b.k and same_expr(a.value, b.value)
                and same_expr(a.pred, b.pred) and a.fetch == b.fetch
                and same_node(a.child, b.child))
    return False


def same_query(a: Optional["Query"], b: Optional["Query"]) -> bool:
    """Structural equality of two queries (names ignored)."""
    if a is None or b is None:
        return a is b
    return same_node(a.root, b.root)


def conjuncts(e: Expr) -> list:
    """Flatten a conjunction into its factors."""
    if isinstance(e, BinOp) and e.op == "and":
        return conjuncts(e.lhs) + conjuncts(e.rhs)
    return [e]


def query_params(node) -> tuple:
    """All :class:`Param` placeholders an operator tree (or ``Query``)
    binds, deduplicated by name, in deterministic scan-first order — the
    ordered parameter signature of a prepared plan.  Raises
    :class:`IRValidationError` when one name is declared with conflicting
    dtype/range."""
    if isinstance(node, Query):
        node = node.root
    if isinstance(node, Scan):
        return ()
    ps = query_params(node.child)
    if isinstance(node, Filter):
        ps += expr_params(node.pred)
    elif isinstance(node, Project):
        for _, e in node.cols:
            ps += expr_params(e)
    elif isinstance(node, SemiJoin):
        ps += expr_params(node.key) + expr_params(node.pred)
    elif isinstance(node, Exists):
        ps += expr_params(node.pred)
    elif isinstance(node, GroupAgg):
        for k in node.keys:
            ps += expr_params(k.expr)
        for a in node.aggs:
            ps += expr_params(a.expr)
    elif isinstance(node, GroupAggByKey):
        ps += expr_params(node.key)
        for a in node.aggs:
            ps += expr_params(a.expr)
    elif isinstance(node, TopK):
        ps += expr_params(node.value) + expr_params(node.pred)
    return _dedup_params(ps)


def substitute(e: Expr, env: Mapping[str, Expr]) -> Expr:
    """Inline projected columns so derived expressions read base columns.
    A projection may shadow the column it reads (``x = x * 2``), so while
    expanding a name that name is excluded from further expansion."""
    if isinstance(e, Col):
        if e.name not in env:
            return e
        inner = {k: v for k, v in env.items() if k != e.name}
        return substitute(env[e.name], inner)
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute(e.lhs, env), substitute(e.rhs, env))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, substitute(e.operand, env))
    if isinstance(e, Bin):
        return Bin(substitute(e.child, env), e.edges)
    return e


# ---------------------------------------------------------------------------
# logical operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Scan:
    """Leaf: the partitioned base table (one partition per node)."""

    table: str


@dataclasses.dataclass(frozen=True, eq=False)
class Filter:
    child: object
    pred: Expr


@dataclasses.dataclass(frozen=True, eq=False)
class Project:
    """Add derived columns (name -> expression over the stream)."""

    child: object
    cols: tuple  # ((name, Expr), ...)


@dataclasses.dataclass(frozen=True, eq=False)
class SemiJoin:
    """Keep stream rows whose foreign ``key`` points at a row of ``table``
    satisfying ``pred`` — the paper's §3.2.2 remote-attribute filter.

    alt: "auto" picks local evaluation for co-partitioned edges, else the
    cheaper of Alt-1 (request exchange) / Alt-2 (replicated bitset) under
    the byte-accurate cost model; "local"/"request"/"bitset" pin it."""

    child: object
    table: str
    key: Expr
    pred: Expr
    alt: str = "auto"  # auto | local | request | bitset


@dataclasses.dataclass(frozen=True, eq=False)
class Exists:
    """EXISTS probe: keep stream rows (over their base table) for which some
    row of the co-partitioned ``table`` with ``key`` == the stream row's
    primary key satisfies ``pred`` (Q4's late-lineitem probe)."""

    child: object
    table: str
    key: str  # foreign-key column of ``table`` referencing the stream's base
    pred: Expr


@dataclasses.dataclass(frozen=True, eq=False)
class GroupKey:
    name: str
    expr: Expr
    cardinality: int


@dataclasses.dataclass(frozen=True, eq=False)
class Agg:
    name: str
    agg: str  # sum | count | min | max (min/max do not lower)
    expr: Optional[Expr] = None  # None for count

    VALID = ("sum", "count", "min", "max")


@dataclasses.dataclass(frozen=True, eq=False)
class GroupAgg:
    """Grouped aggregation over small composite key spaces.  Result: dense
    ``(prod(cardinalities), len(aggs))`` array, groups in row-major key
    order."""

    child: object
    keys: tuple  # (GroupKey, ...) — may be empty (global aggregate)
    aggs: tuple  # (Agg, ...)
    method: str = "auto"  # auto | onehot | dense | kernel


@dataclasses.dataclass(frozen=True, eq=False)
class GroupAggByKey:
    """Dense group-by on a co-partitioned foreign key: aggregates stream
    rows into one value per row of the parent ``into`` table (Q18's
    quantity per order), yielding a stream over ``into`` with the aggregate
    names as derived columns."""

    child: object
    key: Expr  # foreign-key column referencing ``into``'s primary key
    into: str
    aggs: tuple  # (Agg, ...) — sum/count only


@dataclasses.dataclass(frozen=True)  # field equality: plain strings only
class Fetch:
    """Late-materialized output attribute (§3.2.7).  ``table=None`` fetches
    ``name`` from the stream's own table (derived columns included);
    otherwise ``name`` is fetched from ``table`` keyed by the previously
    fetched attribute ``key``."""

    name: str
    table: Optional[str] = None
    key: Optional[str] = None


@dataclasses.dataclass(frozen=True, eq=False)
class TopK:
    """Global top-k of the stream by ``value`` (desc, primary key asc
    tiebreak), via per-node selection + the §3.2.3 merging reduction."""

    child: object
    value: Expr
    k: int
    pred: Optional[Expr] = None
    fetch: tuple = ()


# ---------------------------------------------------------------------------
# catalog: what the validator/lowerer knows about the data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Cheap per-column statistics (min, max, distinct count)."""

    lo: float
    hi: float
    n_distinct: int  # 0 = unknown (float domains)


@dataclasses.dataclass(frozen=True)
class PackedInfo:
    """Resident encoding of a bit-packed column: width/offset for
    frame-of-reference columns, the sorted ``values`` tuple for dictionary
    columns — what the lowering needs to rewrite predicates into code
    space and to predict bytes scanned."""

    width: int
    offset: int = 0
    values: Optional[tuple] = None
    dtype: str = "int32"


@dataclasses.dataclass(frozen=True)
class TableInfo:
    name: str
    columns: tuple
    replicated: bool
    num_rows: int
    stats: Mapping[str, ColumnStats] = dataclasses.field(default_factory=dict)
    # packed-resident columns: name -> PackedInfo (empty = raw residency)
    packed: Mapping[str, PackedInfo] = dataclasses.field(default_factory=dict)


# TPC-H co-partitioned edges (solid edges of the paper's Fig. 1):
# child table -> (parent table, child's foreign-key column)
TPCH_COPARTITIONED = {
    "lineitem": ("orders", "l_orderkey"),
    "partsupp": ("part", "ps_partkey"),
}


@dataclasses.dataclass(frozen=True)
class Catalog:
    tables: Mapping[str, TableInfo]
    copartitioned: Mapping[str, tuple]
    num_nodes: int = 1

    def table(self, name: str) -> TableInfo:
        try:
            return self.tables[name]
        except KeyError:
            raise IRValidationError(
                f"unknown table {name!r}; catalog has {sorted(self.tables)}"
            ) from None


def build_catalog(tables: Mapping[str, object], *, num_nodes: int = 1,
                  copartitioned: Optional[Mapping[str, tuple]] = None,
                  packed: Optional[Mapping[str, Mapping[str, PackedInfo]]] = None,
                  ) -> Catalog:
    """Catalog from host-side tables whose columns are numpy arrays (the
    driver's decoded ``tables`` view): column names, replication, and
    min/max/distinct stats.  ``packed`` declares the resident encoding per
    table/column."""
    infos = {}
    for name, t in tables.items():
        stats = {}
        num_rows = 0
        for cname, col in t.columns.items():
            arr = np.asarray(col)
            num_rows = arr.shape[0]
            if arr.size == 0:
                continue
            lo, hi = float(arr.min()), float(arr.max())
            if arr.dtype == np.bool_:
                nd = 2
            elif np.issubdtype(arr.dtype, np.integer):
                nd = int(min(hi - lo + 1, arr.shape[0]))
            else:
                nd = 0
            stats[cname] = ColumnStats(lo=lo, hi=hi, n_distinct=nd)
        infos[name] = TableInfo(
            name=name,
            columns=tuple(t.columns.keys()),
            replicated=bool(getattr(t, "replicated", False)),
            num_rows=int(num_rows),
            stats=stats,
            packed=dict((packed or {}).get(name, {})),
        )
    return Catalog(
        tables=infos,
        copartitioned=dict(TPCH_COPARTITIONED if copartitioned is None
                           else copartitioned),
        num_nodes=num_nodes,
    )


# ---------------------------------------------------------------------------
# validation: IR tree x catalog -> stream schema (or a typed error)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamInfo:
    """Inferred schema of the tuple stream at a node: the base table whose
    partitioning the stream follows, plus all visible column names."""

    base: str
    columns: frozenset


def _check_bound(expr: Expr, stream: StreamInfo, what: str):
    missing = expr_columns(expr) - stream.columns
    if missing:
        raise IRValidationError(
            f"{what} references unbound column(s) {sorted(missing)} — the "
            f"stream over {stream.base!r} has {sorted(stream.columns)}"
        )


def validate(node, catalog: Catalog) -> StreamInfo:
    """Validate an operator tree bottom-up; returns the root's stream
    schema.  Raises :class:`IRValidationError` with a precise message."""
    if isinstance(node, Scan):
        info = catalog.table(node.table)
        return StreamInfo(base=node.table, columns=frozenset(info.columns))

    if isinstance(node, Filter):
        s = validate(node.child, catalog)
        _check_bound(node.pred, s, "filter predicate")
        return s

    if isinstance(node, Project):
        s = validate(node.child, catalog)
        cols = set(s.columns)
        for name, e in node.cols:
            _check_bound(e, dataclasses.replace(s, columns=frozenset(cols)),
                         f"projection {name!r}")
            cols.add(name)
        return StreamInfo(base=s.base, columns=frozenset(cols))

    if isinstance(node, SemiJoin):
        s = validate(node.child, catalog)
        _check_bound(node.key, s, "semijoin key")
        target = catalog.table(node.table)
        if target.replicated:
            raise IRValidationError(
                f"semijoin against replicated table {node.table!r}: "
                f"replicated tables are not partitioned — evaluate the "
                f"predicate locally with project/filter instead"
            )
        t_stream = StreamInfo(base=node.table,
                              columns=frozenset(target.columns))
        _check_bound(node.pred, t_stream, "semijoin predicate")
        if node.alt not in ("auto", "local", "request", "bitset"):
            raise IRValidationError(f"unknown semijoin alt {node.alt!r}")
        return s

    if isinstance(node, Exists):
        s = validate(node.child, catalog)
        inner = catalog.table(node.table)
        if inner.replicated:
            raise IRValidationError(
                f"exists-probe against replicated table {node.table!r}: "
                f"replicated tables are not partitioned"
            )
        edge = catalog.copartitioned.get(node.table)
        if edge is None or edge[0] != s.base or edge[1] != node.key:
            raise IRValidationError(
                f"exists-probe needs {node.table!r} co-partitioned with the "
                f"stream's base table {s.base!r} on {node.key!r}; known "
                f"co-partitioned edges: {dict(catalog.copartitioned)}"
            )
        if node.key not in inner.columns:
            raise IRValidationError(
                f"exists key {node.key!r} is not a column of {node.table!r}"
            )
        i_stream = StreamInfo(base=node.table,
                              columns=frozenset(inner.columns))
        _check_bound(node.pred, i_stream, "exists predicate")
        return s

    if isinstance(node, GroupAgg):
        s = validate(node.child, catalog)
        seen = set()
        for k in node.keys:
            if k.cardinality is None or k.cardinality <= 0:
                raise IRValidationError(
                    f"group key {k.name!r} needs a positive cardinality"
                )
            _check_bound(k.expr, s, f"group key {k.name!r}")
            if k.name in seen:
                raise IRValidationError(f"duplicate output name {k.name!r}")
            seen.add(k.name)
        for a in node.aggs:
            if a.agg not in Agg.VALID:
                raise IRValidationError(
                    f"aggregate {a.name!r}: unknown kind {a.agg!r} "
                    f"(valid: {Agg.VALID})"
                )
            if a.agg != "count":
                if a.expr is None:
                    raise IRValidationError(
                        f"aggregate {a.name!r}: {a.agg} needs an expression"
                    )
                _check_bound(a.expr, s, f"aggregate {a.name!r}")
            if a.name in seen:
                raise IRValidationError(f"duplicate output name {a.name!r}")
            seen.add(a.name)
        if node.method not in ("auto", "onehot", "dense", "kernel"):
            raise IRValidationError(f"unknown group-agg method {node.method!r}")
        return StreamInfo(base=s.base, columns=frozenset(seen))

    if isinstance(node, GroupAggByKey):
        s = validate(node.child, catalog)
        parent = catalog.table(node.into)
        edge = catalog.copartitioned.get(s.base)
        if (edge is None or edge[0] != node.into
                or not isinstance(node.key, Col) or node.key.name != edge[1]):
            raise IRValidationError(
                f"group_by_key into {node.into!r} needs the stream's base "
                f"table {s.base!r} co-partitioned with it on the key column; "
                f"known co-partitioned edges: {dict(catalog.copartitioned)}"
            )
        _check_bound(node.key, s, "group_by_key key")
        cols = set(parent.columns)
        for a in node.aggs:
            if a.agg not in ("sum", "count"):
                raise IRValidationError(
                    f"group_by_key aggregate {a.name!r}: only sum/count are "
                    f"supported (got {a.agg!r})"
                )
            if a.agg != "count":
                _check_bound(a.expr, s, f"aggregate {a.name!r}")
            cols.add(a.name)
        return StreamInfo(base=node.into, columns=frozenset(cols))

    if isinstance(node, TopK):
        s = validate(node.child, catalog)
        _check_bound(node.value, s, "top-k value")
        if node.pred is not None:
            _check_bound(node.pred, s, "top-k predicate")
        if node.k <= 0:
            raise IRValidationError("top-k needs k > 0")
        fetched = set()
        for f in node.fetch:
            if f.table is None:
                if f.name not in s.columns:
                    raise IRValidationError(
                        f"fetch {f.name!r}: not a column of the stream over "
                        f"{s.base!r}"
                    )
            else:
                remote = catalog.table(f.table)
                if f.name not in remote.columns:
                    raise IRValidationError(
                        f"fetch {f.name!r}: not a column of {f.table!r}"
                    )
                if f.key is None or f.key not in fetched:
                    raise IRValidationError(
                        f"remote fetch {f.name!r} from {f.table!r} needs "
                        f"key= one of the previously fetched attributes "
                        f"({sorted(fetched) or 'none yet'})"
                    )
            fetched.add(f.name)
        return s

    raise IRValidationError(f"unknown operator {type(node).__name__}")


# ---------------------------------------------------------------------------
# the fluent builder
# ---------------------------------------------------------------------------


def _as_group_key(k) -> GroupKey:
    if isinstance(k, GroupKey):
        return k
    name, expr = k[0], _wrap(k[1])
    card = k[2] if len(k) > 2 else None
    if card is None and isinstance(expr, Bin):
        card = expr.cardinality
    return GroupKey(name=name, expr=expr, cardinality=card)


def _as_agg(a) -> Agg:
    if isinstance(a, Agg):
        return a
    name, kind = a[0], a[1]
    expr = a[2] if len(a) > 2 else None
    return Agg(name=name, agg=kind,
               expr=_wrap(expr) if expr is not None else None)


@dataclasses.dataclass(frozen=True, eq=False)
class Query:
    """An IR tree plus an optional name."""

    root: object
    name: Optional[str] = None

    def _with(self, root) -> "Query":
        return Query(root=root, name=self.name)

    def filter(self, pred: Expr) -> "Query":
        return self._with(Filter(self.root, _wrap(pred)))

    def project(self, **cols) -> "Query":
        items = tuple((n, _wrap(e)) for n, e in cols.items())
        return self._with(Project(self.root, items))

    def semijoin(self, table: str, key: Expr, pred: Expr,
                 alt: str = "auto") -> "Query":
        return self._with(SemiJoin(self.root, table, _wrap(key), _wrap(pred),
                                   alt))

    def exists(self, table: str, key: str, pred: Expr) -> "Query":
        return self._with(Exists(self.root, table, key, _wrap(pred)))

    def group_agg(self, keys: Sequence = (), aggs: Sequence = (),
                  method: str = "auto") -> "Query":
        return self._with(GroupAgg(
            self.root,
            keys=tuple(_as_group_key(k) for k in keys),
            aggs=tuple(_as_agg(a) for a in aggs),
            method=method,
        ))

    def group_by_key(self, key: Expr, into: str, aggs: Sequence) -> "Query":
        return self._with(GroupAggByKey(
            self.root, _wrap(key), into, tuple(_as_agg(a) for a in aggs)
        ))

    def top_k(self, value: Expr, k: int, pred: Optional[Expr] = None,
              fetch: Sequence = ()) -> "Query":
        return self._with(TopK(
            self.root, _wrap(value), int(k),
            _wrap(pred) if pred is not None else None, tuple(fetch),
        ))

    def named(self, name: str) -> "Query":
        return Query(root=self.root, name=name)

    @property
    def table(self) -> str:
        """Base table of the root stream (the leaf scan's table)."""
        node = self.root
        while not isinstance(node, Scan):
            node = node.child
        return node.table


class Q:
    """Entry point: ``Q.scan("lineitem")``."""

    @staticmethod
    def scan(table: str) -> Query:
        return Query(root=Scan(table))
