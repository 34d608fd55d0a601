"""Node-stacked single-pass rollup-cube builder (tier-1 materialization).

Counterpart of ``repro.cube.build``.  The build is one plan in the
engine's own model (``Cluster.compile``): every node scans its partition
of the base table once and computes a dense partial aggregate over the
cube's composite key space with the engine's local-aggregation substrate
(the one-hot product of ``core.aggregation``, a dense scatter-add, or the
fused grouped-aggregation kernel B2), and the partials are merged with one
reduction over the node axis per aggregate kind (``psum`` for sum/count,
``allreduce_min``/``allreduce_max`` for min/max) — the paper's "custom
reduce operator merges the partial result sets", §3.2.3.  Coarser rollups
are marginals of the finest and are derived inside the same plan, so N
rollups cost ONE scan of the node-stacked columns.  Packed residents are
decoded when the plan first reads them, as for the hand plans.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch.core import aggregation, exchange
from repro_torch.core.engine import psum
from repro_torch.cube.spec import CubeSpec

ROWS = "__rows"  # internal per-cell row count, present in every rollup


def rollup_key(dims) -> str:
    return ",".join(dims)


def _codes(dim, cols):
    """(P, n) int32 codes of one dimension: binned columns digitized
    against the edges in the column's dtype (code ``j`` covers
    ``(edges[j-1], edges[j]]``), categorical ones clipped into range."""
    col = cols[dim.column]
    if dim.binned:
        edges = torch.tensor(dim.edges, dtype=col.dtype, device=col.device)
        return torch.searchsorted(edges, col.contiguous(),
                                  right=False).to(torch.int32)
    return torch.clamp(col.to(torch.int32), 0, dim.cardinality - 1)


def _measure_values(measure, cols):
    """(P, n) f32 values of a sum/min/max measure (a count's are the
    plan's ones)."""
    from repro_torch.query.ir import Expr, eval_expr

    if isinstance(measure.column, Expr):
        col = eval_expr(measure.column, cols)
    elif callable(measure.column):
        col = measure.column(cols)
    else:
        col = cols[measure.column]
    return col.to(torch.float32)


def _local_sums(spec, key, stacked, num_cells):
    """(P, G, C) partial sums of the sum/count measure stack."""
    method = spec.resolve_method()
    if method == "kernel":
        from repro_torch.kernels import ops

        if num_cells > spec.KERNEL_MAX_GROUPS:
            raise ValueError(
                f"cube {spec.name}: {num_cells} cells exceeds the kernel limit "
                f"{spec.KERNEL_MAX_GROUPS}"
            )
        # no build-time predicate: every row has pred 0 <= cutoff 0
        pred = torch.zeros(key.shape, dtype=torch.int32, device=key.device)
        return ops.filtered_group_sum(stacked.contiguous(), key.contiguous(),
                                      pred, cutoff=0, num_groups=num_cells)
    if method == "onehot":
        return aggregation.group_sum_onehot(stacked, key, num_cells)
    # dense scatter-add, one column at a time (large key spaces)
    outs = [aggregation.group_sum_dense(stacked[..., c], key, num_cells)
            for c in range(stacked.shape[-1])]
    return torch.stack(outs, dim=-1)


def make_build_plan(spec: CubeSpec):
    """Plan(ctx, tables) -> {rollup_key: {measure: dense tensor}}: the
    merged cube, every node's partial reduced over the node axis."""

    sum_like = [m for m in spec.measures if m.agg in ("sum", "count")]
    minmax = [m for m in spec.measures if m.agg in ("min", "max")]
    if spec.resolve_method() == "kernel" and minmax:
        raise ValueError(
            f"cube {spec.name}: the grouped_agg kernel path supports only "
            f"sum/count measures"
        )

    def plan(ctx, t):
        cols = t[spec.table]
        codes = [_codes(d, cols) for d in spec.dimensions]
        key = codes[0]
        for d, c in zip(spec.dimensions[1:], codes[1:]):
            key = key * d.cardinality + c
        G = spec.num_cells
        ones = torch.ones(key.shape, dtype=torch.float32, device=key.device)

        # one scan: sums/counts as a stacked (P, n, C) pass + a rows column
        stacked = torch.stack(
            [ones if m.agg == "count" else _measure_values(m, cols)
             for m in sum_like] + [ones], dim=-1)
        sums = psum(_local_sums(spec, key, stacked, G))
        del stacked

        finest = {}
        for i, m in enumerate(sum_like):
            finest[m.name] = sums[:, i].reshape(spec.shape)
        finest[ROWS] = sums[:, len(sum_like)].reshape(spec.shape)

        # min/max: scatter into sentinel-initialized cells, merged over
        # the node axis
        idx = key.to(torch.int64)
        for m in minmax:
            v = _measure_values(m, cols)
            sentinel = torch.inf if m.agg == "min" else -torch.inf
            init = torch.full((key.shape[0], G), sentinel,
                              dtype=torch.float32, device=key.device)
            local = init.scatter_reduce_(1, idx, v,
                                         "amin" if m.agg == "min" else "amax",
                                         include_self=True)
            merged = (exchange.allreduce_min(local) if m.agg == "min"
                      else exchange.allreduce_max(local))
            finest[m.name] = merged.reshape(spec.shape)

        # coarser rollups: marginalize the finest inside the same plan
        out = {}
        for rollup in spec.rollups:
            axes = tuple(
                i for i, d in enumerate(spec.dimensions) if d.name not in rollup
            )
            arrays = {}
            for name, arr in finest.items():
                agg = _agg_of(spec, name)
                if not axes:
                    arrays[name] = arr
                elif agg in ("sum", "count"):
                    arrays[name] = torch.sum(arr, dim=axes)
                elif agg == "min":
                    arrays[name] = torch.amin(arr, dim=axes)
                else:
                    arrays[name] = torch.amax(arr, dim=axes)
            out[rollup_key(rollup)] = arrays
        return out

    return plan


def _agg_of(spec: CubeSpec, measure_name: str) -> str:
    if measure_name == ROWS:
        return "count"
    for m in spec.measures:
        if m.name == measure_name:
            return m.agg
    raise KeyError(measure_name)


@dataclasses.dataclass
class Cube:
    """A built cube: host-resident dense rollup arrays, served in-process.

    rollups: dim-name tuple (spec order) -> {measure name: np.ndarray whose
    axes follow the dim tuple}.  Empty cells hold 0 for sum/count and
    +/-inf sentinels for min/max (``rows`` distinguishes truly-empty cells).
    """

    spec: CubeSpec
    rollups: dict
    build_seconds: float = 0.0
    rows_scanned: int = 0

    def rollup(self, dims) -> Mapping[str, np.ndarray]:
        return self.rollups[tuple(dims)]

    @property
    def num_values(self) -> int:
        return sum(
            a.size for r in self.rollups.values() for a in r.values()
        )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_cube(cluster, ctx, placed, spec: CubeSpec) -> Cube:
    """Bind + run the build plan over already-placed tables (the driver's
    ``placed``); returns the host-side ``Cube``.  ``build_seconds`` is
    the plan's wall time with the device synchronized on both sides."""
    plan = make_build_plan(spec)
    fn = cluster.compile(plan, ctx)
    columns = {n: t.columns for n, t in placed.items()}
    _sync(ctx.device)
    t0 = time.perf_counter()
    out = fn(columns)
    _sync(ctx.device)
    dt = time.perf_counter() - t0
    rollups = {}
    # spec.rollups entries are name tuples in declaration order; arrays follow
    # the SPEC order of those dims (marginalization preserves axis order)
    for rollup in spec.rollups:
        ordered = tuple(n for n in spec.dim_names if n in rollup)
        rollups[ordered] = {
            name: arr.cpu().numpy()
            for name, arr in out[rollup_key(rollup)].items()
        }
    nrows = placed[spec.table].num_rows
    return Cube(spec=spec, rollups=rollups, build_seconds=dt,
                rows_scanned=nrows)
