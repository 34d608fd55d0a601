"""Query registry: one ``QueryDef`` per TPC-H query/variant (paper §4.3).

Counterpart of ``repro.core.plans``.  Each entry binds, explicitly:

- ``plan``    the hand-written physical plan function (one function per
              query, run over the node-stacked cluster, paper §3.2),
              and/or
- ``ir``      the declarative Query IR (``repro_torch.query``) that lowers
              to the same substrate, and
- ``oracle``  the ``repro_torch.tpch.reference`` key this query validates
              against (so ``q15_1factor`` and ``q21_late`` answer ``q15``
              and ``q21`` by name, not by string munging).

``PLANS`` is the name -> hand-plan mapping; ``get`` raises a typed
:class:`UnknownPlanError` for an unknown name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.plans.distributed_topk import (
    q15,
    q15_1factor,
    q15_approx,
    q21,
    q21_late,
)
from repro_torch.core.plans.local import q1, q1_kernel, q4, q6, q18
from repro_torch.core.plans.semijoin_plans import (
    q2,
    q3,
    q3_lazy,
    q3_repl,
    q5,
    q11,
    q13,
    q14,
)
from repro_torch.query.ir import Query, UnknownPlanError
from repro_torch.tpch.queries import IR_QUERIES


@dataclasses.dataclass(frozen=True)
class QueryDef:
    """A registered query: physical plan and/or logical IR, plus the
    explicit oracle binding."""

    name: str
    oracle: Optional[str]                 # repro_torch.tpch.reference key
    plan: Optional[Callable] = None       # hand-written physical plan
    ir: Optional[Query] = None            # declarative IR (lowerable)


def _d(name, oracle, plan=None):
    return QueryDef(name=name, oracle=oracle, plan=plan,
                    ir=IR_QUERIES.get(name))


REGISTRY = {
    q.name: q
    for q in (
        _d("q1", "q1", q1),
        _d("q1_kernel", "q1", q1_kernel),
        _d("q2", "q2", q2),
        _d("q3", "q3", q3),
        _d("q3_lazy", "q3", q3_lazy),
        _d("q3_repl", "q3", q3_repl),
        _d("q4", "q4", q4),
        _d("q5", "q5", q5),
        _d("q6", "q6", q6),
        _d("q11", "q11", q11),
        _d("q13", "q13", q13),
        _d("q14", "q14", q14),
        # IR-only (no hand plan): the Q14 semi-join shape
        _d("q14_promo", None),
        _d("q15", "q15", q15),
        _d("q15_1factor", "q15", q15_1factor),
        _d("q15_approx", "q15", q15_approx),
        _d("q18", "q18", q18),
        _d("q21", "q21", q21),
        _d("q21_late", "q21", q21_late),
    )
}



def get(name: str) -> QueryDef:
    try:
        return REGISTRY[name]
    except KeyError:
        raise UnknownPlanError(
            f"unknown query {name!r}; registered: {sorted(REGISTRY)}"
        ) from None


# physical layer, name -> hand plan
PLANS = {n: d.plan for n, d in REGISTRY.items() if d.plan is not None}
