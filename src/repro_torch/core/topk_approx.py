"""Top-k selection on distributed partial aggregates (paper §3.2.5),
node-stacked.

Counterpart of ``repro.core.topk_approx``.  Every node holds a partial sum
for every key; the total per key is the sum over all nodes.  The paper's
algorithm ships only a few BITS per partial sum:

  1. encode each partial sum with m bits at a bit offset shared by a group
     of keys (the offset is the highest one-bit of the group maximum),
  2. personalized all-to-all routes the codes to each key's owner node,
  3. owners decode per-source lower/upper bounds and sum them per key,
  4. a merging reduction finds the global k-th highest LOWER bound; every
     key whose UPPER bound is below it is pruned,
  5. exact partial sums are fetched only for the surviving candidates,
  6. a final merging reduction selects the global top-k.

Float adaptation (as in the JAX package): one scalar max fixes a
fixed-point scale, partials are quantized to 30-bit integers, and the
bounds are widened by one quantum and a float epsilon so pruning stays
safe for f32 totals.  Steps 1-2 run the m-bit encoder kernel (B6,
``kernels.ops.mbit_encode``) on the (P_src, P_dst, Kp) rows; the unmasked
local top-k of steps 4 and of the simple baseline runs the block top-k
kernel (B4) and ranks its candidates.  Sums over the P sources run in node
order, as XLA reduces them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import exchange, topk as topk_mod
from repro_torch.core.engine import any_across, cluster_nodes, node_ids, psum
from repro_torch.kernels import ops, ref


class ApproxTopKStats(NamedTuple):
    naive_bits_per_node: torch.Tensor   # what the simple solution ships
    approx_bits_per_node: torch.Tensor  # step-2 codes + step-5 exact fetch
    num_candidates: torch.Tensor        # survivors after pruning (global)


def encode_partials(partials_u32, m: int, group: int):
    """Step 1 before packing: m-bit codes with a group-shared shift.
    (..., K) int32 (uint32 values < 2**31) -> codes (..., K) int32 in [0,
    2**m), shifts (..., K / group) int32."""
    return ref.mbit_codes(partials_u32, m, group)


def decode_bounds(codes, shifts, group: int):
    """Lower/upper bounds (int64 holding uint32) from codes + group
    shifts."""
    return ref.code_bounds(codes, shifts, group)


_QUANT_BITS = 30
_EPS = 1e-6


def sum_sources(x):
    """Sum of the per-source axis 1 of (P_dst, P_src, ...) in source order."""
    acc = x[:, 0]
    for s in range(1, x.shape[1]):
        acc = acc + x[:, s]
    return acc


def owner_keys(num_nodes: int, kp: int, device):
    """Global keys of each local owner's range: (L, Kp) int32,
    ascending."""
    return (node_ids(num_nodes, device)[:, None] * kp
            + torch.arange(kp, device=device)).to(torch.int32)


def local_topk_blocks(values, keys, k: int, block: int = 4096):
    """``topk.local_topk(values, keys, k)`` for UNMASKED finite values
    (L, n) whose keys ascend with the row, through the block top-k kernel
    (B4): every block's k best by (value desc, index asc) are its k best by
    (value desc, key asc), so ranking the blocks' candidates gives the
    same k rows bit for bit.  A masked top-k must stay on the sort: on a
    block that runs out of unmasked rows B4 repeats a key."""
    L = values.shape[0]
    cand_v, cand_k = ops.block_topk(values.contiguous(), keys.contiguous(),
                                    k=k, block=block)
    return topk_mod.local_topk(cand_v.reshape(L, -1), cand_k.reshape(L, -1),
                               k)


def _first_row(t: topk_mod.TopK) -> topk_mod.TopK:
    """Every node's row holds the global winners after the reduction."""
    return topk_mod.TopK(*(a[0] for a in t))


def approx_topk_distributed(partials, k: int, *, m: int = 8,
                            group: int = 1024, candidate_capacity: int,
                            backend: str = "xla"):
    """§3.2.5 end to end over the node-stacked cluster.

    partials: (L, K) f32 per local node, NON-NEGATIVE partial sums over
        the global key space (K divisible by P * group, keys
        range-partitioned).
    Returns (TopK over global totals, (k,) each; stats; overflow)."""
    L, K = partials.shape
    P = cluster_nodes(L)
    if K % P:
        raise ValueError("key space must be divisible by node count")
    Kp = K // P
    if Kp % group:
        raise ValueError("per-node key range must hold whole groups")
    dev = partials.device

    # ---- step 0: fixed-point quantization (float adaptation) ------------
    partials = partials.to(torch.float32)
    gmax = exchange.allreduce_max(partials.amax(dim=1))
    scale = (torch.tensor(float(1 << _QUANT_BITS), device=dev)
             / torch.clamp(gmax, min=1e-30))
    q = torch.clamp(torch.floor(partials * scale), 0,
                    float(1 << _QUANT_BITS)).to(torch.int32)

    # ---- steps 1-2: encode + pack per destination (B6), all-to-all ------
    words, shifts = ops.mbit_encode(q.reshape(L, P, Kp), m=m, group=group)
    recv_words = exchange.all_to_all(words, backend=backend)
    recv_shifts = exchange.all_to_all(shifts, backend=backend)

    # ---- step 3: per-source bounds, summed per key ----------------------
    lo_q, hi_q = ops.mbit_decode_bounds(recv_words, recv_shifts, m=m,
                                        group=group)
    # back to value space; widen by one quantum (+float eps) so bounds stay
    # valid despite the floor() quantization and f32 rounding
    inv = 1.0 / scale
    eps = torch.tensor(_EPS, dtype=torch.float32, device=dev)
    lo = sum_sources(lo_q.to(torch.float32) * inv) * (1.0 - eps)
    hi = sum_sources((hi_q.to(torch.float32) + 1.0) * inv) * (1.0 + eps)

    # ---- step 4: global k-th highest lower bound (B4) -------------------
    keys = owner_keys(P, Kp, dev)
    global_lo = topk_mod.topk_allreduce(local_topk_blocks(lo, keys, k))
    threshold = global_lo.values[:, k - 1:k]

    # ---- step 5: prune, fetch exact partials for survivors --------------
    cand_mask = hi >= threshold
    counts = cand_mask.sum(dim=1)
    num_candidates = psum(counts).to(torch.int32)
    C = min(candidate_capacity, Kp)
    # stable left-pack of the candidate keys into a fixed buffer
    order = torch.sort((~cand_mask).to(torch.int8), dim=1,
                       stable=True).indices[:, :C]
    cand_valid = torch.gather(cand_mask, 1, order)
    cand_keys = torch.where(cand_valid, torch.gather(keys, 1, order), 0)
    overflow = any_across((counts > C).any())
    # everyone learns everyone's candidates, answers with its exact partials
    all_cand = exchange.allgather(cand_keys).reshape(L, P, C)
    all_valid = exchange.allgather(cand_valid).reshape(L, P, C)
    replies = torch.gather(partials, 1,
                           all_cand.reshape(L, -1).to(torch.int64))
    replies = torch.where(all_valid, replies.reshape(L, P, C), 0.0)
    exact_totals = sum_sources(exchange.all_to_all(replies, backend=backend))

    # ---- step 6: global top-k over exact candidate totals (masked: sort) -
    local_exact = topk_mod.local_topk(exact_totals, cand_keys, k, cand_valid)
    result = _first_row(topk_mod.topk_allreduce(local_exact))

    f32 = dict(dtype=torch.float32, device=dev)
    stats = ApproxTopKStats(
        naive_bits_per_node=torch.tensor(float(K * 32), **f32),
        approx_bits_per_node=(torch.tensor(float(K * m + (K // group) * 8),
                                           **f32)
                              + torch.tensor(float(C * 32), **f32) * 2.0),
        num_candidates=num_candidates,
    )
    return result, stats, overflow


def simple_topk_distributed(partials, k: int, *, backend: str = "xla"):
    """The paper's naive baseline (Q15 variants 1/2): all-to-all ALL
    partial sums (L, K) to each key's owner, aggregate, then select the
    top-k (B4 and a rank of its candidates).  Returns a TopK of (k,)."""
    L, K = partials.shape
    P = cluster_nodes(L)
    Kp = K // P
    recv = exchange.all_to_all(partials.reshape(L, P, Kp), backend=backend)
    totals = sum_sources(recv)
    local = local_topk_blocks(totals, owner_keys(P, Kp, partials.device), k)
    return _first_row(topk_mod.topk_allreduce(local))
