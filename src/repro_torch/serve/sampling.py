"""Distributed top-k sampling: the paper's §3.2.3 merging reduction applied
to the decode head (counterpart of ``repro.serve.sampling``).

In the JAX package the logits row is sharded over the mesh's ``model``
axis, and each rank selects its local top-k before a log2(P)-round
butterfly merges them, so a token costs O(k log P) bytes on the wire
instead of the whole row.  The port stacks the P vocab shards on a leading
axis of one tensor, as ``core.exchange`` stacks the nodes: logits
(P, B, V/P), shard p holding ids p * V/P .. (p + 1) * V/P - 1.  The local
top-k is ``core.topk.local_topk`` and the butterfly is
``core.exchange.butterfly_allreduce`` with ``core.topk.merge_topk``.
"""
from __future__ import annotations

import torch

from repro_torch.core import exchange
from repro_torch.core import topk as topk_mod


def topk_logits(local_logits, k: int):
    """local_logits (P, B, V/P), P a power of two -> (values (P, B, k),
    ids (P, B, k)): every shard's row holds the global top-k (value
    descending, id ascending on ties), as every rank does after the
    all-reduce."""
    P, B, Vl = local_logits.shape
    ids = (torch.arange(P, device=local_logits.device)[:, None, None] * Vl
           + torch.arange(Vl, device=local_logits.device))
    local = topk_mod.local_topk(local_logits, ids.expand(P, B, Vl), k)
    merged = exchange.butterfly_allreduce(local, topk_mod.merge_topk)
    return merged.values, merged.keys


def distributed_topk_sample(local_logits, k: int, generator: torch.Generator,
                            *, temperature: float = 1.0):
    """Top-k sampling over stacked vocab shards: one categorical draw per
    row from the global top-k, on ``generator`` -> (B,) ids."""
    values, ids = topk_logits(local_logits, k)
    logits = values[0].float() / max(temperature, 1e-6)
    choice = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                               generator=generator)
    return torch.gather(ids[0], 1, choice)[:, 0]


def naive_allgather_argmax(local_logits):
    """The baseline §3.2.3 replaces: gather the whole row, then argmax."""
    P, B, Vl = local_logits.shape
    full = local_logits.permute(1, 0, 2).reshape(B, P * Vl)
    return torch.argmax(full, dim=-1)
