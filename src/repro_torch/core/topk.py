"""Distributed top-k selection (paper §3.2.3), node-stacked.

Counterpart of ``repro.core.topk``:

- ``local_topk``: per-node top-k (step 1 of the paper's scheme).
- ``topk_allreduce``: the merging reduction — sorted k-lists combined
  pairwise, keeping the best k, in a log2(P)-round butterfly.
- ``topk_gather``: the naive gather baseline.
- ``lazy_filtered_topk``: §3.2.4, top-k under a remote filter requested
  lazily for chunks of the locally best candidates.

Ties: ranking uses (valid first, value desc, tiebreak asc), so results are
deterministic and match the numpy oracle.  torch has no ``lexsort``: the
order is built from successive stable sorts, least significant key first.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import exchange
from repro_torch.core.engine import any_across

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
    nodes (across ranks too); every node's row ends with the global
    top-k."""
    return exchange.butterfly_allreduce(local, merge_topk)


def topk_gather(local: TopK) -> TopK:
    """Naive baseline: gather all P·k candidates, then select k: (k,)."""
    k = local.values.shape[-1]
    flat = TopK(*(a.reshape(-1) for a in local))
    return _take(flat, _rank_order(*flat)[:k])


def lazy_filtered_topk(values, keys, mask, remote_filter: Callable, k: int,
                       *, chunk: int, max_rounds: int):
    """§3.2.4: top-k of each node's (P, n) rows where a remote predicate
    disqualifies keys.

    ``remote_filter(keys, mask) -> (bits, overflow)`` evaluates the remote
    predicate for a masked (P, chunk) chunk of keys (an Alt-1 request).
    Each node's candidates are ranked once; round i examines ranks
    ``[i * chunk, (i + 1) * chunk)`` of every node that has fewer than k
    survivors, while any node has fewer than k and unexamined candidates
    (nodes that are done send an empty request: the exchange is
    collective), at most ``max_rounds`` rounds.  Whether to go on is one
    host read a round, of a flag reduced across ranks first (as the
    reference's ``psum``), so every rank runs the same rounds.  One merging reduction then finds the global
    winners.  Returns (the per-node TopK of ``topk_allreduce``, overflow).

    A round whose chunk runs past the row pads it with the last key,
    masked, as the JAX package's clamped indices do; only ranks inside the
    row are updated."""
    n = values.shape[1]
    dev = values.device
    order = _rank_order(values, keys, mask)
    svalid = torch.gather(mask, 1, order)
    sv = torch.where(svalid, torch.gather(values, 1, order).to(torch.float32),
                     NEG_INF)
    sk = torch.gather(keys, 1, order)
    passed = torch.zeros_like(svalid)     # passed the remote filter
    examined = torch.zeros_like(svalid)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(chunk, device=dev)
    for i in range(max_rounds):
        done = (passed & examined).sum(1) >= k
        if not bool(any_across((~done & (svalid & ~examined).any(1)).any())):
            break
        start = i * chunk
        idx = (start + slots).clamp(max=n - 1)
        cm = (svalid[:, idx] & (start + slots < n)) & ~done[:, None]
        bits, ovf = remote_filter(sk[:, idx], cm)
        w = min(chunk, n - start)
        cm, bits = cm[:, :w], bits[:, :w]
        part = passed[:, start:start + w]
        passed[:, start:start + w] = torch.where(cm, bits, part)
        examined[:, start:start + w] |= cm
        overflow = overflow | ovf
    local = local_topk(sv, sk, k, passed & examined & svalid)
    return topk_allreduce(local), overflow
