"""Runtime-parameter canonicalization: separate a query's SHAPE from its
literal VALUES.

Counterpart of ``repro.query.params``.  The paper's engine compiles each
query once and re-executes it with runtime parameters (§2, §3.1).
:func:`parameterize` rewrites every literal that is a comparison operand
inside a predicate (``Filter``/``SemiJoin``/``TopK``) into an auto-named
:class:`~repro_torch.query.ir.Param`, and returns the parameterized shape
with the extracted binding.  Two trees that differ only in predicate
literals canonicalize to the SAME shape (the names ``_p0, _p1, ...`` are
given in a deterministic scan-first order), so they share one lowered plan
and differ only in the scalars passed at execute time.

A literal ``int`` becomes an int32 ``Param`` and a ``float`` a float32
one, as in the reference: through ``TPCHDriver.query`` a float literal
compares in float32 (``lower`` of a literal tree keeps its float64
compare).  Literals that are structural — ``Bin`` edges, group-key
cardinalities, ``TopK.k``, arithmetic constants inside measures (``1.0 -
l_discount``) — stay: they shape the plan.

:func:`bind_params` is the inverse: it substitutes a binding back into a
parameterized tree and yields the literal query.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from repro_torch.query.ir import (
    Bin,
    BinOp,
    Exists,
    Filter,
    GroupAgg,
    GroupAggByKey,
    GroupKey,
    Lit,
    Param,
    Project,
    Query,
    Scan,
    SemiJoin,
    TopK,
    UnaryOp,
    _FLIP_CMP,
    query_params,
)

_AUTO_PREFIX = "_p"


def _param_dtype(value) -> Optional[str]:
    """Numpy dtype name for a parameterizable scalar, or None when the
    value must stay a literal (strings, tuples, ...)."""
    if isinstance(value, (bool, np.bool_)):
        return "bool"
    if isinstance(value, (np.integer, np.floating)):
        return value.dtype.name
    if isinstance(value, int):
        return "int32"
    if isinstance(value, float):
        return "float32"
    return None


def parameterize(q: Query) -> tuple:
    """``(shape, binding)``: ``q`` with every predicate comparison literal
    replaced by an auto-named ``Param`` (``_p0, _p1, ...`` in scan-first
    order), and the extracted name -> value binding.  Explicit params are
    untouched; a ``method='kernel'`` GroupAgg root is left as it is (the
    fused kernel takes its cutoff as a constant)."""
    root = q.root
    if isinstance(root, GroupAgg) and root.method == "kernel":
        return q, {}
    taken = {p.name for p in query_params(root)}
    binding: dict = {}

    def _fresh(value) -> Optional[Param]:
        dtype = _param_dtype(value)
        if dtype is None:
            return None
        i = len(binding)
        name = f"{_AUTO_PREFIX}{i}"
        while name in taken:
            i += 1
            name = f"{_AUTO_PREFIX}{i}"
        taken.add(name)
        binding[name] = value.item() if hasattr(value, "item") else value
        return Param(name, dtype)

    def rw_pred(e):
        if isinstance(e, UnaryOp) and e.op == "not":
            return UnaryOp("not", rw_pred(e.operand))
        if not isinstance(e, BinOp):
            return e
        if e.op in ("and", "or"):
            return BinOp(e.op, rw_pred(e.lhs), rw_pred(e.rhs))
        if e.op in _FLIP_CMP:
            lhs, rhs = e.lhs, e.rhs
            # exactly one literal side becomes a parameter; Lit-vs-Lit is
            # a structural constant, and literals inside arithmetic
            # operands stay
            if isinstance(rhs, Lit) and not isinstance(lhs, Lit):
                p = _fresh(rhs.value)
                if p is not None:
                    return BinOp(e.op, lhs, p)
            elif isinstance(lhs, Lit) and not isinstance(rhs, Lit):
                p = _fresh(lhs.value)
                if p is not None:
                    return BinOp(e.op, p, rhs)
        return e

    def walk(node):
        if isinstance(node, Scan):
            return node
        child = walk(node.child)
        if isinstance(node, Filter):
            return Filter(child, rw_pred(node.pred))
        if isinstance(node, SemiJoin):
            return dataclasses.replace(node, child=child,
                                       pred=rw_pred(node.pred))
        if isinstance(node, TopK):
            pred = rw_pred(node.pred) if node.pred is not None else None
            return dataclasses.replace(node, child=child, pred=pred)
        return dataclasses.replace(node, child=child)

    return Query(root=walk(root), name=q.name), binding


def bind_params(q: Query, binding: Mapping[str, object]) -> Query:
    """Substitute ``binding`` back into a parameterized query, replacing
    each bound ``Param`` with a ``Lit`` of its value (unbound params stay;
    check :func:`~repro_torch.query.ir.query_params` on the result where a
    fully literal tree is required)."""

    def rwe(e):
        if e is None:
            return None
        if isinstance(e, Param) and e.name in binding:
            v = binding[e.name]
            return Lit(v.item() if hasattr(v, "item") else v)
        if isinstance(e, BinOp):
            return BinOp(e.op, rwe(e.lhs), rwe(e.rhs))
        if isinstance(e, UnaryOp):
            return UnaryOp(e.op, rwe(e.operand))
        if isinstance(e, Bin):
            return Bin(rwe(e.child), e.edges)
        return e

    def walk(node):
        if isinstance(node, Scan):
            return node
        child = walk(node.child)
        if isinstance(node, Filter):
            return Filter(child, rwe(node.pred))
        if isinstance(node, Project):
            return Project(child, tuple((n, rwe(e)) for n, e in node.cols))
        if isinstance(node, SemiJoin):
            return dataclasses.replace(node, child=child, key=rwe(node.key),
                                       pred=rwe(node.pred))
        if isinstance(node, Exists):
            return dataclasses.replace(node, child=child, pred=rwe(node.pred))
        if isinstance(node, GroupAgg):
            keys = tuple(GroupKey(k.name, rwe(k.expr), k.cardinality)
                         for k in node.keys)
            aggs = tuple(dataclasses.replace(a, expr=rwe(a.expr))
                         for a in node.aggs)
            return dataclasses.replace(node, child=child, keys=keys, aggs=aggs)
        if isinstance(node, GroupAggByKey):
            aggs = tuple(dataclasses.replace(a, expr=rwe(a.expr))
                         for a in node.aggs)
            return dataclasses.replace(node, child=child, key=rwe(node.key),
                                       aggs=aggs)
        if isinstance(node, TopK):
            return dataclasses.replace(node, child=child,
                                       value=rwe(node.value),
                                       pred=rwe(node.pred))
        return dataclasses.replace(node, child=child)

    return Query(root=walk(q.root), name=q.name)
