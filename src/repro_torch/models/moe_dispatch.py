"""Expert-parallel MoE dispatch over the exchange layer (counterpart of
``repro.models.moe_dispatch``).

The MoE block of ``models.moe`` keeps every token beside every expert.
Here the tokens are sharded over the nodes and so are the experts, and
routing is a personalized all-to-all: the paper's §3.1 "route work to its
owner" with the expert id as the key and the §3.2.6 schedule selectable
(``"xla"``: one transpose, one ``all_to_all_single`` across ranks;
``"one_factor"``: the P-round schedule).  Where the JAX function runs
under ``shard_map`` on one node's tokens, the port takes the nodes
stacked on the leading axis, as the rest of ``core`` does.

A node runs its experts on the rows it received sorted by local expert,
as batched products over (local nodes x local experts, C, .).  The
reference instead gathers each received row's expert weights (an einsum
into (P, cap, d, f)), which at qwen3-moe's width would be about 13 GB a
node; the two compute the same function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import exchange
from repro_torch.core.engine import cluster_nodes
from repro_torch.models import moe


def moe_block_sharded(p, x, cfg, *, backend: str = "xla",
                      capacity_factor: float = 2.0):
    """x (L, N_local, d): the tokens of the L local nodes.  ``p`` holds
    ``router`` (d, E), the same on every node, and each local node's
    expert shard, ``w_gate``/``w_up`` (L, E_local, d, f) and ``w_down``
    (L, E_local, f, d), expert e on node e // E_local.  Returns (y
    (L, N_local, d), overflow): a pair past its destination's capacity is
    dropped, sets ``overflow`` and adds nothing to its token."""
    m = cfg.moe
    L, N, d = x.shape
    P = cluster_nodes(L)
    E, K = m.num_experts, m.top_k
    E_local = E // P
    top_p, top_e = moe.route(p["router"], x, K)
    flat_e = top_e.reshape(L, N * K)
    owner = flat_e // E_local
    mask = torch.ones_like(flat_e, dtype=torch.bool)
    cap = int(N * K * capacity_factor // P) + 8
    # ship (expert id, token row) to the expert's owner
    re, rx, rmask, (dest, slot), ovf = exchange.exchange_vectors_by_owner(
        flat_e, x.repeat_interleave(K, dim=1), mask, owner, capacity=cap,
        backend=backend)
    # the received rows sorted by local expert: an expert receives at most
    # one pair a token from each sender (a token's K experts differ)
    M, C = P * cap, P * min(cap, N)
    local_e = torch.where(rmask, re % E_local, E_local).reshape(L, M)
    src, valid, pos = moe.sorted_runs(local_e, E_local, C)
    rows = torch.gather(rx.reshape(L, M, d), 1,
                        src.reshape(L, -1, 1).expand(-1, -1, d))
    xe = torch.where(valid.reshape(L, -1, 1), rows, 0)
    w = {k: p[k].reshape(L * E_local, *p[k].shape[2:])
         for k in ("w_gate", "w_up", "w_down")}
    out = moe.expert_ffn(xe.reshape(L * E_local, C, d), w["w_gate"],
                         w["w_up"], w["w_down"]).reshape(L, E_local * C, d)
    # back to the received slots, then to the senders (the second
    # all-to-all)
    at = local_e.clamp(max=E_local - 1) * C + pos.clamp(0, C - 1)
    res = torch.gather(out, 1, at[..., None].expand(-1, -1, d))
    res = torch.where(rmask.reshape(L, M, 1), res, 0)
    back = exchange.all_to_all(res.reshape(L, P, cap, d), backend=backend)
    # a pair's result sits at (its destination, its slot) if it was
    # delivered: its rank among the pairs to that owner is below cap
    onehot = F.one_hot(owner, P)
    rank = (onehot.cumsum(1) * onehot).sum(-1) - 1
    at = dest.clamp(max=P - 1) * cap + slot
    y = moe.combine(back.reshape(L, M, d), at, mask & (rank < cap),
                    top_p.reshape(L, N * K), N, K, x.dtype)
    return y, ovf
