"""Shared plan helpers, node-stacked.

Counterpart of ``repro.core.plans.common``.  A *plan* is the paper's
hand-translated query function.  In the JAX package it runs inside
shard_map and sees one node's partition; here it runs once over the
node-stacked cluster and sees every node's partition on the leading axis
(``(P, rows_per_node)`` columns), and synchronizes through the collectives
of :mod:`repro_torch.core.exchange` and :func:`repro_torch.core.engine.psum`.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import PlanContext
from repro_torch.tpch.schema import DEFAULT_PARAMS  # noqa: F401  (re-export)


def local_index(ctx: PlanContext, table: str, global_keys):
    """Global dense keys (P, n) -> row index on the owner, int64
    (co-partitioned access: the caller guarantees the keys are locally
    owned)."""
    return global_keys.to(torch.int64) - ctx.part(table).my_base(ctx.device)


def my_keys(ctx: PlanContext, table: str):
    """Global keys of every node's partition: (P, rows_per_node) int32."""
    return ctx.part(table).global_keys(ctx.device).to(torch.int32)


def revenue(li):
    """extendedprice * (1 - discount) — the TPC-H revenue measure."""
    return li["l_extendedprice"] * (1.0 - li["l_discount"])


def _masked_f32(values, mask):
    v = values.to(torch.float32)
    return v if mask is None else torch.where(mask, v, 0.0)


def dense_local_sum(ctx: PlanContext, table: str, keys_global, values,
                    mask=None):
    """Scatter-add values (P, n) into a dense per-row vector of each node's
    LOCAL partition of ``table``: (P, rows_per_node) f32 (keys must be
    locally owned — co-partitioned group-by)."""
    idx = local_index(ctx, table, keys_global)
    v = _masked_f32(values, mask)
    out = torch.zeros(v.shape[0], ctx.part(table).rows_per_node,
                      dtype=torch.float32, device=v.device)
    return out.scatter_add_(1, idx, v)


def dense_partials(ctx: PlanContext, table: str, keys_global, values,
                   mask=None):
    """Scatter-add values (P, n) into a dense vector over the GLOBAL key
    space of ``table`` per node: (P, total_rows) f32 (partial aggregates
    for a remote group-by key — the §3.2.5 input)."""
    v = _masked_f32(values, mask)
    out = torch.zeros(v.shape[0], ctx.part(table).total_rows,
                      dtype=torch.float32, device=v.device)
    return out.scatter_add_(1, keys_global.to(torch.int64), v)
