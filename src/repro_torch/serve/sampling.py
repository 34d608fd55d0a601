"""Distributed top-k sampling: the paper's §3.2.3 merging reduction applied
to the decode head (counterpart of ``repro.serve.sampling``).

The logits row is split over the vocabulary; each shard selects its local
top-k, and a log2(P)-round butterfly merges them, so a token costs
O(k log P) bytes on the wire instead of the whole row.  Two forms:

- across ranks (``mesh=``): this rank's (B, V_local) logits are its block
  of a vocabulary split row-major over the mesh dims ``axes``, as in the
  reference's ``shard_map`` over its ``model`` axes.  Round r swaps the
  (B, k) values and ids with the partner ``index ^ 2^r`` of the group
  over those dims (``torch.distributed`` point-to-point), and every rank
  of the group ends with the global top-k;
- stacked in one process: the P vocab shards on a leading axis of one
  tensor, as ``core.exchange`` stacks the nodes: logits (P, B, V/P),
  shard p holding ids p * V/P .. (p + 1) * V/P - 1, merged by
  ``core.exchange.butterfly_allreduce``.

The local top-k is ``core.topk.local_topk`` and the merge
``core.topk.merge_topk``: values descending, ids ascending on ties.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import exchange
from repro_torch.core import topk as topk_mod
from repro_torch.core.engine import _DIST_CALLS, record_collective


def _flat_index(mesh, axes) -> tuple[int, int]:
    """(this rank's row-major index over the mesh dims ``axes``, the
    number of ranks they hold)."""
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    idx, n = 0, 1
    for ax in axes:
        j = names.index(ax)
        idx = idx * mesh.size(j) + coord[j]
        n *= mesh.size(j)
    return idx, n


def _rank_at(mesh, axes, idx: int) -> int:
    """The global rank at row-major index ``idx`` over ``axes`` whose
    other mesh coordinates are this rank's."""
    names, coord = mesh.mesh_dim_names, list(mesh.get_coordinate())
    for ax in reversed(axes):
        j = names.index(ax)
        coord[j] = idx % mesh.size(j)
        idx //= mesh.size(j)
    return int(mesh.mesh[tuple(coord)])


def _swap(peer: int, tensors: list) -> list:
    """Send ``tensors`` to ``peer`` and receive its tensors of the same
    shapes, in one batch of point-to-point operations."""
    recv = [torch.empty_like(t) for t in tensors]
    batch = []
    for tag, (s, r) in enumerate(zip(tensors, recv)):
        batch += [dist.P2POp(dist.isend, s, peer, tag=tag),
                  dist.P2POp(dist.irecv, r, peer, tag=tag)]
    _DIST_CALLS["batch_isend_irecv"] += 1
    for work in dist.batch_isend_irecv(batch):
        work.wait()
    return recv


def topk_logits(local_logits, k: int, *, mesh=None, axes=("model",)):
    """The global top-k of vocab-sharded logits: (values, ids), values
    descending, ids ascending on ties.

    Stacked (no ``mesh``): local_logits (P, B, V/P), P a power of two ->
    (values (P, B, k), ids (P, B, k)); every shard's row holds the global
    top-k, as every rank does after the all-reduce.

    Across ranks: local_logits (B, V_local), this rank's block; its ids
    start at its row-major index over ``axes`` times V_local (the
    reference's ``vocab_offset``) -> (values (B, k) f32, ids (B, k)
    int32), the same on every rank of the group, whose size must be a
    power of two.  Each round is recorded in
    ``core.exchange.collective_record``: B*k values and B*k ids."""
    if mesh is None:
        P, B, Vl = local_logits.shape
        ids = (torch.arange(P, device=local_logits.device)[:, None, None]
               * Vl + torch.arange(Vl, device=local_logits.device))
        local = topk_mod.local_topk(local_logits, ids.expand(P, B, Vl), k)
        merged = exchange.butterfly_allreduce(local, topk_mod.merge_topk)
        return merged.values, merged.keys
    B, Vl = local_logits.shape
    idx, P = _flat_index(mesh, axes)
    if P & (P - 1):
        raise ValueError(f"the butterfly needs a power-of-two group, the "
                         f"mesh dims {axes} hold {P} ranks")
    ids = idx * Vl + torch.arange(Vl, dtype=torch.int32,
                                  device=local_logits.device)
    state = topk_mod.local_topk(local_logits, ids.expand(B, Vl), k)
    for r in range(P.bit_length() - 1):
        sent = [state.values.contiguous(), state.keys.contiguous()]
        for t in sent:
            record_collective("collective-permute", t[None],
                              f"topk_butterfly{r}")
        vals, keys = _swap(_rank_at(mesh, axes, idx ^ (1 << r)), sent)
        state = topk_mod.merge_topk(
            state, topk_mod.TopK(vals, keys, torch.ones_like(state.valid)))
    return state.values, state.keys


def distributed_topk_sample(local_logits, k: int, generator: torch.Generator,
                            *, temperature: float = 1.0, mesh=None,
                            axes=("model",)):
    """Top-k sampling over vocab-sharded logits (either form of
    :func:`topk_logits`): one categorical draw per row from the global
    top-k, on ``generator`` -> (B,) ids.  Across ranks every rank draws
    the same token when the generators are seeded alike."""
    values, ids = topk_logits(local_logits, k, mesh=mesh, axes=axes)
    if mesh is None:
        values, ids = values[0], ids[0]
    logits = values.float() / max(temperature, 1e-6)
    choice = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                               generator=generator)
    return torch.gather(ids, 1, choice)[:, 0]


def naive_allgather_argmax(local_logits, *, mesh=None, axes=("model",)):
    """The baseline §3.2.3 replaces: gather the whole row, then argmax.
    Stacked: (P, B, V/P); across ranks: this rank's (B, V_local) block,
    all-gathered over the mesh dims ``axes`` (recorded as one all-gather
    of B*V_local values, the reference's operand)."""
    if mesh is None:
        P, B, Vl = local_logits.shape
        full = local_logits.permute(1, 0, 2).reshape(B, P * Vl)
        return torch.argmax(full, dim=-1)
    record_collective("all-gather", local_logits[None], "naive_allgather")
    full = local_logits.contiguous()
    for ax in reversed(axes):           # the innermost dim first
        j = mesh.mesh_dim_names.index(ax)
        n = mesh.size(j)
        if n == 1:
            continue
        out = torch.empty((n * full.shape[0], full.shape[1]),
                          dtype=full.dtype, device=full.device)
        dist.all_gather_into_tensor(out, full, group=mesh.get_group(j))
        full = out.view(n, *full.shape).transpose(0, 1).reshape(
            full.shape[0], -1)
    return torch.argmax(full, dim=-1)
