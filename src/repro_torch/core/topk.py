"""Distributed top-k selection (paper §3.2.3), node-stacked.

Counterpart of ``repro.core.topk``:

- ``local_topk``: per-node top-k (step 1 of the paper's scheme).
- ``topk_allreduce``: the merging reduction — sorted k-lists combined
  pairwise, keeping the best k, in a log2(P)-round butterfly.
- ``topk_gather``: the naive gather baseline.

Ties: ranking uses (valid first, value desc, tiebreak asc), so results are
deterministic and match the numpy oracle.  torch has no ``lexsort``: the
order is built from successive stable sorts, least significant key first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import exchange

NEG_INF = float("-inf")


class TopK(NamedTuple):
    values: torch.Tensor  # (..., k) f32, descending
    keys: torch.Tensor    # (..., k) int — payload (row key) per entry
    valid: torch.Tensor   # (..., k) bool


def _rank_order(values, tiebreak, valid):
    """Per-row order (last axis): valid first, value desc, tiebreak asc."""
    v = torch.where(valid, values.to(torch.float32), NEG_INF)
    order = torch.sort(tiebreak, dim=-1, stable=True).indices
    for key in (-v, (~valid).to(torch.int8)):
        nxt = torch.sort(torch.gather(key, -1, order), dim=-1,
                         stable=True).indices
        order = torch.gather(order, -1, nxt)
    return order


def _take(t: TopK, order) -> TopK:
    return TopK(*(torch.gather(a, -1, order) for a in t))


def local_topk(values, keys, k: int, mask=None) -> TopK:
    """Top-k rows of each node's partition (P, n) by value desc, key asc:
    (P, k) each."""
    valid = torch.ones_like(values, dtype=torch.bool) if mask is None \
        else mask
    order = _rank_order(values, keys, valid)[..., :k]
    vals = torch.where(valid, values.to(torch.float32), NEG_INF)
    return _take(TopK(vals, keys, valid), order)


def merge_topk(a: TopK, b: TopK) -> TopK:
    """The paper's user-defined reduce operator: merge two sorted k-lists
    (per row), keep the best k."""
    k = a.values.shape[-1]
    both = TopK(*(torch.cat([x, y], dim=-1) for x, y in zip(a, b)))
    return _take(both, _rank_order(*both)[..., :k])


def topk_allreduce(local: TopK) -> TopK:
    """§3.2.3 merging reduction as a recursive-doubling butterfly over the
    node axis; every node's row ends with the global top-k."""
    return exchange.butterfly_allreduce(local, merge_topk)


def topk_gather(local: TopK) -> TopK:
    """Naive baseline: gather all P·k candidates, then select k: (k,)."""
    k = local.values.shape[-1]
    flat = TopK(*(a.reshape(-1) for a in local))
    return _take(flat, _rank_order(*flat)[:k])
