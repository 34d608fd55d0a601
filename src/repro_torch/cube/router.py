"""Tier-1 query router: answer aggregate queries from rollup cubes.

Counterpart of ``repro.cube.router``; it runs on the host over the port's
``query.ir``.

The router matches the declarative Query IR directly: a ``GroupAgg`` root
over ``Filter``/``Project`` chains on a scan is DERIVED into the internal
``AggQuery`` form per cube spec (group keys -> dimensions by column/edges,
measures -> spec measures by structural expression equality, filter
conjuncts -> dimension predicates), then the cheapest covering rollup —
contains every grouped/filtered dimension, can express every filter
exactly, has every measure — answers it by masking + marginalizing the
dense rollup array on the host (microseconds; no device round-trip).
Queries that derive or route to nothing return ``None`` and the caller
falls back to Tier 2, the lowered plan over the base tables
(``TPCHDriver.query``).

Exactness rule for binned dimensions: bin ``j`` covers ``(edges[j-1],
edges[j]]``, so a range predicate is answerable iff its bound lands on an
edge (``<= v`` with ``v`` an edge; ``> v`` likewise; integer domains also
get ``< v`` / ``>= v`` via the ``v - 1`` edge).  Anything else is routed to
Tier 2 rather than answered approximately.

PARAMETERIZED predicates (``col op Param``, the prepared-statement form)
split that decision across time: at prepare/route time only the SHAPE is
checked (the filtered column must be a dimension of a covering rollup —
value exactness cannot be known yet), and at execute time
:meth:`CubeRouter.answer_bound` substitutes the binding and applies the
edge-exactness rule per call — an in-range binding on an edge serves Tier
1, anything else returns None and the caller falls back to the prepared
Tier-2 plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.cube.build import ROWS, Cube
from repro_torch.cube.spec import Dimension
from repro_torch.query import ir as qir


@dataclasses.dataclass(frozen=True)
class Filter:
    """Predicate on one cube dimension.  For categorical dims ``value`` is a
    dictionary code (or tuple of codes for op "in"); for binned dims it is a
    raw column value tested against the bin edges.  A
    :class:`~repro_torch.query.ir.Param` value is a placeholder resolved at
    execute time (:meth:`CubeRouter.answer_bound`)."""

    dim: str
    op: str  # ==, in, <=, <, >=, >
    value: object

    @property
    def parameterized(self) -> bool:
        return isinstance(self.value, qir.Param)


@dataclasses.dataclass(frozen=True)
class AggQuery:
    """The router's internal matched form: an aggregate query named in one
    spec's dimension/measure vocabulary.  Derived from a ``GroupAgg`` IR
    root by :func:`derive_agg_query`; can also be built directly in tests.

    group_by: dimension names, in output-axis order.
    measures: measure names, stacked on the last output axis.
    filters: conjunctive predicates on cube dimensions.
    """

    table: str
    group_by: tuple
    measures: tuple
    filters: tuple = ()


@dataclasses.dataclass(frozen=True)
class Route:
    cube: Cube
    rollup: tuple  # ordered dim names of the chosen rollup

    @property
    def cells(self) -> int:
        return self.cube.spec.rollup_cells(self.rollup)


@dataclasses.dataclass(frozen=True)
class Match:
    """A successful IR->cube match: the derived AggQuery plus its route."""

    query: AggQuery
    route: Route


# ---------------------------------------------------------------------------
# IR -> AggQuery derivation (per spec)
# ---------------------------------------------------------------------------


def _measure_expr(m) -> Optional[qir.Expr]:
    """Spec measure as an IR expression, or None if unmatchable (legacy
    callable measures)."""
    if isinstance(m.column, qir.Expr):
        return m.column
    if isinstance(m.column, str):
        return qir.Col(m.column)
    return None


def _dim_for_key(spec, key: qir.GroupKey) -> Optional[Dimension]:
    """Cube dimension matching a group key: plain ``Col`` -> categorical
    dim of that column with the same cardinality; ``Bin`` -> binned dim of
    that column with identical edges."""
    e = key.expr
    if isinstance(e, qir.Col):
        for d in spec.dimensions:
            if d.column == e.name and not d.binned \
                    and d.cardinality == key.cardinality:
                return d
    elif isinstance(e, qir.Bin) and isinstance(e.child, qir.Col):
        for d in spec.dimensions:
            if d.column == e.child.name and d.binned \
                    and d.edges == e.edges:
                return d
    return None


def _dim_for_column(spec, column: str) -> Optional[Dimension]:
    for d in spec.dimensions:
        if d.column == column:
            return d
    return None


def derive_agg_query(q: "qir.Query", spec) -> Optional[AggQuery]:
    """Express an IR query in ``spec``'s vocabulary, or None when the query
    is not cube-shaped for this spec (non-GroupAgg root, operators a cube
    cannot represent, unknown measures/dimensions)."""
    root = q.root
    if not isinstance(root, qir.GroupAgg):
        return None
    # walk the chain below the GroupAgg: only Filter/Project over a Scan of
    # the spec's table are representable; projections are inlined
    chain = []
    node = root.child
    while not isinstance(node, qir.Scan):
        if not isinstance(node, (qir.Filter, qir.Project)):
            return None  # SemiJoin/Exists/GroupAggByKey: not cube-shaped
        chain.append(node)
        node = node.child
    if node.table != spec.table:
        return None
    # resolve scan-upward so each binding/predicate sees only the
    # projections BELOW it; stored env entries are fully base-column
    # expressions, and an upper projection may shadow a lower one
    filters = []
    env = {}
    for op in reversed(chain):
        if isinstance(op, qir.Filter):
            filters.append(qir.substitute(op.pred, env) if env else op.pred)
        else:
            for name, e in op.cols:
                env[name] = qir.substitute(e, env) if env else e

    def subst(e):
        return qir.substitute(e, env) if env else e

    group_by = []
    for key in root.keys:
        d = _dim_for_key(spec, dataclasses.replace(key, expr=subst(key.expr))
                         if env else key)
        if d is None:
            return None
        group_by.append(d.name)

    measures = []
    for agg in root.aggs:
        found = None
        for m in spec.measures:
            if m.agg != agg.agg:
                continue
            if agg.agg == "count" or qir.same_expr(_measure_expr(m),
                                                   subst(agg.expr)):
                found = m.name
                break
        if found is None:
            return None
        measures.append(found)

    dim_filters = []
    for pred in filters:  # already substituted at collection position
        for factor in qir.conjuncts(pred):
            norm = qir.normalize_comparison(factor)
            if norm is None:
                return None
            column, op, value = norm
            d = _dim_for_column(spec, column)
            if d is None:
                return None
            dim_filters.append(Filter(d.name, op, value))

    return AggQuery(
        table=spec.table,
        group_by=tuple(group_by),
        measures=tuple(measures),
        filters=tuple(dim_filters),
    )


# ---------------------------------------------------------------------------
# filter masks over a dimension's code space
# ---------------------------------------------------------------------------


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer))


def _filter_mask(dim, flt: Filter):
    """Boolean mask over ``dim``'s code space, or None if the predicate is
    not exactly expressible on this dimension's granularity."""
    card = dim.cardinality
    codes = np.arange(card)
    if not dim.binned:
        v = flt.value
        if flt.op == "==":
            return codes == v
        if flt.op == "in":
            return np.isin(codes, np.asarray(list(v)))
        if flt.op == "<=":
            return codes <= v
        if flt.op == "<":
            return codes < v
        if flt.op == ">=":
            return codes >= v
        if flt.op == ">":
            return codes > v
        return None
    # binned: translate the raw bound to an edge index.  Strict bounds are
    # rewritten through v-1 only on declared-integer domains (on floats,
    # '< 10' != '<= 9') — otherwise they are inexact and go to Tier 2.
    edges = np.asarray(dim.edges)
    op, v = flt.op, flt.value
    if op == "<" and dim.integral and _is_int(v):
        op, v = "<=", v - 1
    if op == ">=" and dim.integral and _is_int(v):
        op, v = ">", v - 1
    j = np.searchsorted(edges, v)
    if j >= len(edges) or edges[j] != v:
        # the bound cuts INSIDE a bin (including the open first/last bins,
        # which extend beyond the edge list) — not exact, Tier 2
        return None
    if op == "<=":
        return codes <= j
    if op == ">":
        return codes > j
    return None


class CubeRouter:
    """Match queries (IR or derived AggQuery form) against built cubes.

    With an :class:`repro_torch.obs.Observer` attached (``obs``), routing
    decisions feed the metrics registry: ``router.match`` / ``router.miss``
    count tier-1 coverage at route time, and ``router.offedge_fallback``
    counts bound executions a matched route had to hand back to Tier 2
    because the binding was not exactly expressible on the cube's bin
    edges."""

    def __init__(self, cubes: Sequence[Cube], obs=None):
        self.cubes = list(cubes)
        self.obs = obs

    def _count(self, name: str):
        if self.obs is not None and self.obs.metrics is not None:
            self.obs.metrics.counter(name).inc()

    def add(self, cube: Cube):
        self.cubes.append(cube)

    # -- matching -----------------------------------------------------------
    def _match_cube(self, cube: Cube, q: AggQuery) -> Optional[Route]:
        """Cheapest covering rollup of ONE cube, or None."""
        spec = cube.spec
        if spec.table != q.table:
            return None
        if not set(q.measures) <= set(spec.measure_names):
            return None
        needed = set(q.group_by) | {f.dim for f in q.filters}
        if not needed <= set(spec.dim_names):
            return None
        # value exactness of parameterized filters is unknowable until a
        # binding arrives — answer_bound() re-checks it per execution
        if any(_filter_mask(spec.dim(f.dim), f) is None
               for f in q.filters if not f.parameterized):
            return None
        for rollup in spec.covering_rollups(needed):
            ordered = tuple(n for n in spec.dim_names if n in rollup)
            if ordered in cube.rollups:
                return Route(cube, ordered)  # sorted; first is cheapest
        return None

    def route(self, q: AggQuery) -> Optional[Route]:
        """Cheapest covering (cube, rollup) for a pre-derived AggQuery."""
        best = None
        for cube in self.cubes:
            route = self._match_cube(cube, q)
            if route is not None and (best is None or route.cells < best.cells):
                best = route
        return best

    def route_query(self, q: "qir.Query") -> Optional[Match]:
        """Match an IR query: derive the AggQuery per spec (dimension and
        measure vocabularies differ between cubes), keep the cheapest
        covering route.  None -> Tier 2."""
        best = None
        for cube in self.cubes:
            aggq = derive_agg_query(q, cube.spec)
            if aggq is None:
                continue
            route = self._match_cube(cube, aggq)
            if route is not None and (
                    best is None or route.cells < best.route.cells):
                best = Match(query=aggq, route=route)
        self._count("router.match" if best is not None else "router.miss")
        if best is not None and self.obs is not None:
            self.obs.event(
                "router.route", cat="route", query=q.name or "<anon>",
                cube=best.route.cube.spec.name,
                rollup="x".join(best.route.rollup),
                cells=best.route.cells,
            )
        return best

    # -- answering ----------------------------------------------------------
    def answer_bound(self, match: Match, binding=None):
        """Execute-time Tier-1 answer for a (possibly parameterized) match:
        substitute ``binding`` into the parameterized filters, THEN apply
        the bin-edge exactness rule per filter.  Returns the dense result,
        or None when any bound value is not exactly expressible on its
        dimension (off-edge or out-of-range binding) — the caller falls
        back to the prepared Tier-2 plan."""
        q, spec = match.query, match.route.cube.spec
        resolved = []
        for f in q.filters:
            if f.parameterized:
                if binding is None or f.value.name not in binding:
                    raise qir.UnboundParamError(
                        f"cube filter on {f.dim!r} needs a binding for "
                        f"parameter {f.value.name!r}"
                    )
                v = binding[f.value.name]
                f = dataclasses.replace(
                    f, value=v.item() if hasattr(v, "item") else v)
            resolved.append(f)
        if any(_filter_mask(spec.dim(f.dim), f) is None for f in resolved):
            self._count("router.offedge_fallback")
            return None
        return self.answer(dataclasses.replace(q, filters=tuple(resolved)),
                           match.route)

    def answer(self, q: AggQuery, route: Optional[Route] = None):
        """Dense result of shape ``(*group_by cardinalities, len(measures))``
        (float64), or None when no cube covers the query.  Empty min/max
        cells come back NaN."""
        if any(f.parameterized for f in q.filters):
            raise qir.UnboundParamError(
                "answer() needs concrete filter values — resolve "
                "parameterized filters via answer_bound(match, binding)"
            )
        route = route or self.route(q)
        if route is None:
            return None
        spec = route.cube.spec
        arrays = route.cube.rollup(route.rollup)
        dims = route.rollup

        rows = arrays[ROWS].astype(np.float64)
        # conjunction of all predicates per dimension (a query may carry
        # several filters on one dim, e.g. a date window)
        masks = {}
        for f in q.filters:
            m = _filter_mask(spec.dim(f.dim), f)
            masks[f.dim] = m if f.dim not in masks else masks[f.dim] & m

        def _shaped(mask, axis):
            shape = [1] * len(dims)
            shape[axis] = mask.shape[0]
            return mask.reshape(shape)

        reduce_axes = tuple(i for i, d in enumerate(dims) if d not in q.group_by)
        rows_f = rows
        for dname, mask in masks.items():
            rows_f = rows_f * _shaped(mask, dims.index(dname))
        rows_out = rows_f.sum(axis=reduce_axes) if reduce_axes else rows_f

        outs = []
        for mname in q.measures:
            agg = next(m.agg for m in spec.measures if m.name == mname)
            arr = arrays[mname].astype(np.float64)
            for dname, mask in masks.items():
                m = _shaped(mask, dims.index(dname))
                if agg in ("sum", "count"):
                    arr = arr * m
                else:
                    fill = np.inf if agg == "min" else -np.inf
                    arr = np.where(m, arr, fill)
            if reduce_axes:
                if agg in ("sum", "count"):
                    arr = arr.sum(axis=reduce_axes)
                elif agg == "min":
                    arr = arr.min(axis=reduce_axes)
                else:
                    arr = arr.max(axis=reduce_axes)
            if agg in ("min", "max"):
                arr = np.where(rows_out > 0, arr, np.nan)
            outs.append(arr)

        kept = [d for d in dims if d in q.group_by]
        stacked = np.stack(outs, axis=-1)
        # reorder the surviving dim axes to the query's group_by order
        perm = [kept.index(g) for g in q.group_by]
        return np.transpose(stacked, perm + [len(kept)])
