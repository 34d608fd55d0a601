"""Grouped aggregation (the paper's local-aggregation substrate, §4.3),
node-stacked.

Counterpart of ``repro.core.aggregation``.  Small-cardinality group-bys
(Q1: 6 groups) are one-hot contractions — a plain batched ``torch.matmul``
of the ``(P, G, n)`` one-hot against the ``(P, n, c)`` measures, where the
JAX package leaves the same dot to XLA; a one-hot past
``ONEHOT_MAX_BYTES`` (a cube's build at SF 10) is summed over chunks of
rows.  Large dense key spaces use scatter-add into a dense vector.  Plans
merge the per-node partials with :func:`repro_torch.core.engine.psum`.

Float32 matrix products must not run in TF32 (about three decimal digits):
``Cluster`` sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.
"""
from __future__ import annotations

import torch


# Largest f32 one-hot of one product: a cube's build (516 cells over 7.5 M
# rows a node at SF 10 is 124 GB) must fit the card beside the data
ONEHOT_MAX_BYTES = 8 << 30
# Most rows a chunk of a chunked product sums in one f32 run: cuBLAS's
# long runs drift (5.6 M rows a node over 48 cells: 1.4e-3 relative)
ONEHOT_CHUNK_ROWS = 1 << 17


def group_sum_onehot(values, group_ids, num_groups: int, mask=None):
    """sum(values) per group and node via a one-hot matmul.

    values: (P, n) or (P, n, c); group_ids: (P, n); mask: (P, n) bool.
    Returns (P, G) or (P, G, c) f32.  Out-of-range ids match no group.
    Where the (P, G, n) f32 one-hot would pass ``ONEHOT_MAX_BYTES``, the
    same product is summed over chunks of rows, each one-hot under it and
    at most ``ONEHOT_CHUNK_ROWS`` rows; below it one product runs."""
    v = values if values.ndim == 3 else values[..., None]
    v = v.to(torch.float32)
    if mask is not None:
        v = torch.where(mask[..., None], v, 0.0)
    groups = torch.arange(num_groups, dtype=group_ids.dtype,
                          device=group_ids.device)
    P, n = group_ids.shape
    step = max(n, 1)
    if 4 * P * num_groups * n > ONEHOT_MAX_BYTES:
        step = max(1, min(ONEHOT_MAX_BYTES // (4 * P * num_groups),
                          ONEHOT_CHUNK_ROWS))
    out = None
    for lo in range(0, max(n, 1), step):
        ids = group_ids[:, lo:lo + step]
        onehot = (ids[:, None, :] == groups[None, :, None])
        part = torch.matmul(onehot.to(torch.float32), v[:, lo:lo + step])
        out = part if out is None else out.add_(part)
        del onehot
    return out if values.ndim == 3 else out[..., 0]


def group_count(group_ids, num_groups: int, mask=None):
    ones = torch.ones(group_ids.shape, dtype=torch.float32,
                      device=group_ids.device)
    return group_sum_onehot(ones, group_ids, num_groups, mask)


def group_sum_dense(values, keys, num_keys: int, mask=None):
    """Dense scatter-add aggregation for large key spaces, per node:
    out[p, keys[p, i]] += values[p, i] -> (P, num_keys) f32."""
    v = values.to(torch.float32)
    keys = keys.to(torch.int64)
    if mask is not None:
        v = torch.where(mask, v, 0.0)
        keys = torch.where(mask, keys, 0)
    out = torch.zeros(v.shape[0], num_keys, dtype=torch.float32,
                      device=v.device)
    return out.scatter_add_(1, keys, v)
