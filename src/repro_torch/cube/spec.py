"""Cube specifications: what to pre-aggregate, at what granularity.

Counterpart of ``repro.cube.spec``.

A ``CubeSpec`` declares, over one named table, a set of *dimensions* (small
integer code spaces) and *measures* (sum/count/min/max of a column), plus the
list of *rollups* (dimension subsets) to materialize.  The builder
(``cube.build``) computes the finest rollup in a single distributed scan and
derives every coarser rollup by marginalization, so the whole spec costs one
pass over the sharded columns.

Dimensions come in two flavors:

- *categorical*: the column already stores dense codes in ``[0, cardinality)``
  (dictionary-encoded strings, small enums).
- *binned*: a numeric column digitized against explicit, sorted ``edges``;
  code ``j`` covers the half-open interval ``(edges[j-1], edges[j]]`` with
  code 0 below the first edge and code ``len(edges)`` above the last.  A
  range predicate is exactly answerable from the cube iff its bound lands on
  an edge — the router checks this and falls back to Tier 2 otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Dimension:
    """One axis of the cube.

    column: source column name in the base table.
    cardinality: number of distinct codes (categorical dims).
    edges: sorted bin edges for binned numeric dims (overrides cardinality:
        the code space is ``len(edges) + 1``).
    integral: asserts the binned column takes only integer values, letting
        the router rewrite strict bounds (``< v`` -> ``<= v-1``); leave
        False for float domains, where such bounds fall back to Tier 2.
    """

    name: str
    column: str
    cardinality: int = 0
    edges: tuple = ()
    integral: bool = False

    def __post_init__(self):
        if self.edges:
            object.__setattr__(self, "edges", tuple(sorted(self.edges)))
            object.__setattr__(self, "cardinality", len(self.edges) + 1)
        if self.cardinality <= 0:
            raise ValueError(f"dimension {self.name}: cardinality must be set")

    @property
    def binned(self) -> bool:
        return bool(self.edges)


AGGS = ("sum", "count", "min", "max")


@dataclasses.dataclass(frozen=True)
class Measure:
    """One aggregate: ``agg(column)`` per cube cell.

    column may be a plain column name, a ``repro_torch.query`` expression (the
    preferred form — the cube router matches IR measures against it
    structurally), or a legacy callable mapping the local column dict to a
    value array.  ``count`` measures ignore the column.
    """

    name: str
    agg: str
    column: object = None

    def __post_init__(self):
        if self.agg not in AGGS:
            raise ValueError(f"measure {self.name}: unknown agg {self.agg!r}")
        if self.agg != "count" and self.column is None:
            raise ValueError(f"measure {self.name}: agg {self.agg} needs a column")


@dataclasses.dataclass(frozen=True)
class CubeSpec:
    """A named cube over one table.

    rollups: dimension-name subsets to materialize; defaults to the single
    finest rollup over all dimensions.  Every rollup must be a subset of
    ``dimensions`` (the finest rollup is always built — coarser ones are its
    marginals).
    method: local aggregation strategy — "auto" (onehot below
    ``ONEHOT_MAX_GROUPS`` cells else dense scatter-add), "onehot", "dense",
    or "kernel" (the fused grouped-aggregation kernel B2,
    ``kernels.ops.filtered_group_sum``; sum/count measures only).
    """

    name: str
    table: str
    dimensions: tuple
    measures: tuple
    rollups: tuple = ()
    method: str = "auto"

    ONEHOT_MAX_GROUPS = 8192
    KERNEL_MAX_GROUPS = 512

    def __post_init__(self):
        names = [d.name for d in self.dimensions]
        if len(set(names)) != len(names):
            raise ValueError(f"cube {self.name}: duplicate dimension names")
        mnames = [m.name for m in self.measures]
        if len(set(mnames)) != len(mnames):
            raise ValueError(f"cube {self.name}: duplicate measure names")
        rollups = tuple(tuple(r) for r in self.rollups) or (tuple(names),)
        for r in rollups:
            unknown = set(r) - set(names)
            if unknown:
                raise ValueError(
                    f"cube {self.name}: rollup over unknown dims {unknown}")
        if tuple(names) not in rollups:
            rollups = (tuple(names),) + rollups
        object.__setattr__(self, "rollups", rollups)
        if self.method not in ("auto", "onehot", "dense", "kernel"):
            raise ValueError(f"cube {self.name}: unknown method {self.method!r}")

    # -- derived geometry ---------------------------------------------------
    def dim(self, name: str) -> Dimension:
        for d in self.dimensions:
            if d.name == name:
                return d
        raise KeyError(name)

    @property
    def dim_names(self) -> tuple:
        return tuple(d.name for d in self.dimensions)

    @property
    def measure_names(self) -> tuple:
        return tuple(m.name for m in self.measures)

    @property
    def shape(self) -> tuple:
        """Cell grid of the finest rollup, one axis per dimension."""
        return tuple(d.cardinality for d in self.dimensions)

    @property
    def num_cells(self) -> int:
        return math.prod(self.shape)

    def rollup_shape(self, rollup: Sequence[str]) -> tuple:
        return tuple(self.dim(n).cardinality for n in rollup)

    def rollup_cells(self, rollup: Sequence[str]) -> int:
        return math.prod(self.rollup_shape(rollup))

    def resolve_method(self) -> str:
        if self.method != "auto":
            return self.method
        return "onehot" if self.num_cells <= self.ONEHOT_MAX_GROUPS else "dense"

    def covering_rollups(self, needed_dims) -> list:
        """Rollups containing every dim in ``needed_dims``, coarsest (fewest
        cells) first — the router picks the cheapest covering slice."""
        needed = set(needed_dims)
        out = [r for r in self.rollups if needed <= set(r)]
        return sorted(out, key=self.rollup_cells)
