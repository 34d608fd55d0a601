"""Static collective model: the program-ordered collective sequence a
lowered plan issues on EVERY shard, derived from the IR chain and the
semi-join decisions — without tracing or compiling anything.

The per-operator mapping mirrors ``query/lower.py``:

- ``SemiJoin`` alt=request  -> ``all-to-all`` x2 packed / x3 raw
  (``core.exchange.request_reply``)
- ``SemiJoin`` alt=bitset   -> ``all-gather`` x1 (``semijoin.alt2_bitset``)
- ``SemiJoin`` alt=local, ``Exists``, ``GroupAggByKey`` -> no collective
  (co-partitioned, purely node-local)
- ``GroupAgg`` root         -> ``all-reduce`` x1 (the final ``psum``)
- ``TopK`` root             -> ``collective-permute`` x ``3*log2(P)``
  (the §3.2.3 butterfly merging reduction permutes values/keys/valid each
  of its log2(P) rounds) + one ``all-reduce`` per late-materialized
  output attribute (§3.2.7 fetch)

Counterpart of ``repro.query.verify.collectives``.  A run of the port's
plan records the same sequence as it executes
(``core.exchange.collective_record``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.query.lower import _chain, decide_semijoins
from repro_torch.query.ir import Catalog, GroupAgg, Query, SemiJoin, TopK


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective step of a plan's static script.

    ``guard``/``in_loop`` describe data-dependent control flow around the
    collective; scripts derived from the IR never set them (the lowering
    has no data-dependent collectives by construction) — they exist so
    fixtures and external lowerings can describe hazardous plans to the
    SPMD analyzers.
    """

    kind: str    # all-to-all | all-gather | all-reduce | collective-permute
    count: int
    source: str  # plan construct that issues it ("q4_sj0", "group_agg", ...)
    guard: Optional[str] = None  # data-dependent predicate gating it
    in_loop: bool = False        # inside a data-dependent loop body

    def describe(self) -> str:
        return f"{self.kind} x{self.count} ({self.source})"

    def signature(self) -> tuple:
        """What must match across shards for the SPMD program to be
        deadlock-free (the source label is allowed to differ)."""
        return (self.kind, self.count)


def collective_script(query, catalog: Catalog, *, wire: str = "packed",
                      binding=None) -> tuple:
    """Program-ordered :class:`CollectiveOp` sequence of the lowered plan.

    Derived from the same ``decide_semijoins`` pass the lowering runs, so
    the script reflects the actual alternative choices (request vs bitset
    vs local) under ``wire`` and ``binding``.
    """
    root = query.root if isinstance(query, Query) else query
    name = query.name if isinstance(query, Query) else None
    decisions = decide_semijoins(
        root, catalog, query_name=name, wire=wire, binding=binding
    )
    num_nodes = max(catalog.num_nodes, 1)
    ops = []
    for node in _chain(root):
        if not isinstance(node, SemiJoin):
            continue
        plan = decisions[id(node)]
        if plan.alt == "request":
            ops.append(CollectiveOp(
                "all-to-all", 2 if plan.wire.packed else 3, plan.key))
        elif plan.alt == "bitset":
            ops.append(CollectiveOp("all-gather", 1, plan.key))
    if isinstance(root, GroupAgg):
        ops.append(CollectiveOp("all-reduce", 1, "group_agg"))
    elif isinstance(root, TopK):
        rounds = int(math.log2(num_nodes)) if num_nodes > 1 else 0
        if rounds:
            # butterfly rounds each ppermute the (values, keys, valid) tuple
            ops.append(CollectiveOp(
                "collective-permute", 3 * rounds, "topk_allreduce"))
        fetches = len(root.fetch)
        if fetches:
            ops.append(CollectiveOp(
                "all-reduce", fetches, "late_materialization"))
    return tuple(ops)


def expected_all_to_alls(script) -> int:
    """All-to-all instruction count the lowered HLO should contain."""
    return sum(op.count for op in script if op.kind == "all-to-all")
