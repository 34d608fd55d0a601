"""Inter-node communication (paper §3.2.6, §4.2) and its wire codec
(§3.2.1), on the node-stacked cluster.

Counterpart of ``repro.core.exchange`` (collectives, the personalized
all-to-all with both backends, the wire format, ``request_reply`` and
``exchange_by_owner``; ``exchange_vectors_by_owner`` is not ported).  The
P nodes are stacked on the leading axis of every tensor, so a collective is
a tensor operation over that axis:

- ``engine.psum`` and ``allreduce_max/min`` reduce over axis 0
  (``allreduce_max`` serves ``topk_approx``; ``allreduce_min``,
  ``broadcast_from`` and ``topk.topk_gather`` have no caller in the
  port's plans yet); ``allgather`` replicates the
  concatenated per-node operands to every node; ``broadcast_from`` copies
  one node's row to all.
- ``all_to_all(x)`` takes ``(P_src, P_dst, ...)`` to ``(P_dst, P_src,
  ...)``: ``"xla"`` is one transpose copy, ``"one_factor"`` the paper's
  P-round schedule, where round i moves the pair ``u <-> (i - u) mod P``.
- ``butterfly_allreduce`` merges in log2 P rounds with partner ``u ^ 2^r``.

Wire formats (:class:`WireFormat`): ``raw`` ships int32 key buckets, a
bool mask and the replies as three all-to-alls; ``packed`` ships each
destination row as one Elias–Fano coded word row with the validity mask
folded in (``kernels.ops.ef_encode``), and boolean replies as bitsets
(``kernels.ops.mask_fold``), so a request/reply round trip is two
all-to-alls.  Packed message row, in 32-bit words::

    [ EF upper bitvector | EF lower bits | mask bitset ]

``all_to_all`` and ``allgather`` count the bytes each node injects (the
operand's bytes over P, the JAX package's per-device operand): read them
with :func:`wire_bytes`, reset them with :func:`reset_wire_bytes`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import compression
from repro_torch.core.engine import psum
from repro_torch.kernels import ops

INT32_MAX = 2 ** 31 - 1

_BYTES = {"all-to-all": 0, "all-gather": 0}


def wire_bytes() -> dict:
    """Collective kind -> bytes per node since the last reset."""
    return dict(_BYTES)


def reset_wire_bytes() -> None:
    for k in _BYTES:
        _BYTES[k] = 0


def _count(kind: str, x: torch.Tensor, nodes: int) -> None:
    _BYTES[kind] += x.numel() * x.element_size() // nodes


# ---------------------------------------------------------------------------
# collectives over the node axis
# ---------------------------------------------------------------------------


def allreduce_max(x):
    """MPI_Allreduce(MAX) of the per-node operands ``x`` (P, ...) over
    the node axis -> (...); a -inf sentinel survives only where every
    node holds it."""
    return x.amax(0)


def allreduce_min(x):
    """MPI_Allreduce(MIN) over the node axis, as :func:`allreduce_max`
    (+inf sentinels)."""
    return x.amin(0)


def allgather(x):
    """MPI_Allgather of the per-node operands ``x`` (P, ...): every node
    receives their concatenation, (P, P * ...) — a broadcast view, no
    copy."""
    P = x.shape[0]
    _count("all-gather", x, P)
    flat = x.reshape(1, -1)
    return flat.expand(P, flat.shape[1])


def broadcast_from(x, root: int):
    """MPI_Bcast: node ``root``'s row of ``x`` (P, ...) to every node."""
    return x[root].expand_as(x)


def all_to_all(x, *, backend: str = "xla"):
    """Personalized all-to-all: ``x[s, d]`` is node s's message to node d;
    returns ``y`` with ``y[d, s] = x[s, d]``.

    backend="xla": one transpose copy.  backend="one_factor": the paper's
    §3.2.6 schedule — P rounds; round i pairs u with v = (i - u) mod P
    (an involution; a node paired with itself copies locally), and every
    pair swaps its two messages."""
    P = x.shape[0]
    if x.shape[1] != P:
        raise ValueError(f"all_to_all needs (P, P, ...) messages, got "
                         f"{tuple(x.shape)}")
    if backend == "xla":
        out = x.transpose(0, 1).contiguous()
    elif backend == "one_factor":
        out = torch.empty_like(x)
        u = torch.arange(P, device=x.device)
        for i in range(P):
            v = (i - u) % P
            # node v receives, from its partner u, the message u -> v
            out[v, u] = x[u, v]
    else:
        raise ValueError(f"unknown all_to_all backend: {backend}")
    _count("all-to-all", x, P)
    return out


def butterfly_allreduce(state, merge: Callable):
    """Allreduce with a user-defined merge in log2(P) rounds: round r
    merges each node's state with that of its partner ``u ^ 2^r``
    (recursive doubling); every node ends with the full reduction.
    ``state`` is a tuple of (P, ...) tensors; P must be a power of two."""
    P = state[0].shape[0]
    if P & (P - 1):
        raise ValueError(f"butterfly requires power-of-two nodes, got {P}")
    u = torch.arange(P, device=state[0].device)
    for r in range(P.bit_length() - 1):
        partner = u ^ (1 << r)
        other = type(state)(*(s[partner] for s in state))
        state = merge(state, other)
    return state


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Wire encoding of an exchange.  ``domain`` is the per-destination key
    domain — ``rows_per_node`` of the range-partitioned target table, so
    every key routed to destination d lies in ``[d*domain, (d+1)*domain)``;
    ``key_bits`` is ``required_width(domain - 1)``."""

    kind: str = "raw"   # "raw" | "packed"
    domain: int = 0
    key_bits: int = 0

    @property
    def packed(self) -> bool:
        return self.kind == "packed" and self.domain > 0

    @classmethod
    def raw(cls) -> "WireFormat":
        return cls()

    @classmethod
    def packed_for(cls, total_rows: int, num_nodes: int) -> "WireFormat":
        dom = max(1, int(total_rows) // max(num_nodes, 1))
        return cls(kind="packed", domain=dom,
                   key_bits=compression.required_width(dom - 1))


def encode_key_buckets(buckets, bucket_mask, wf: WireFormat):
    """(P_src, P_dst, cap) key buckets -> (P_src, P_dst, W) packed rows.
    Valid keys of each row must be a sorted ascending prefix in the
    destination's range (what :func:`_bucket_presorted` produces)."""
    P, _, cap = buckets.shape
    rows = torch.arange(P * P, device=buckets.device)
    base = (rows % P) * wf.domain                   # destination d's range
    msg = ops.ef_encode(buckets.reshape(P * P, cap),
                        bucket_mask.reshape(P * P, cap), base,
                        domain=wf.domain)
    return msg.reshape(P, P, -1)


def decode_key_buckets(words, capacity: int, wf: WireFormat):
    """Inverse of :func:`encode_key_buckets` on the receivers: (P_dst,
    P_src, W) -> (keys (P_dst, P_src, cap) int32, mask bool)."""
    P = words.shape[0]
    rows = torch.arange(P * P, device=words.device)
    my_base = (rows // P) * wf.domain               # the receiver's range
    keys, mask = ops.ef_decode(words.reshape(P * P, -1), my_base,
                               capacity=capacity, domain=wf.domain)
    return (keys.reshape(P, P, capacity), mask.reshape(P, P, capacity))


def _sort_by_key(keys, mask, *aligned):
    """Stable per-node sort by key, masked keys last (INT32_MAX sentinel):
    per-destination buckets come out ascending (the packed codec's
    precondition), and the valid keys form one contiguous run per
    destination (owners are monotone in key).  Returns the permutation and
    the reordered tensors."""
    sentinel = torch.where(mask, keys.to(torch.int64), INT32_MAX)
    order = torch.sort(sentinel, dim=1, stable=True).indices
    return (order, *(torch.gather(a, 1, order)
                     for a in (keys, mask) + aligned))


def _dest_counts(dest, num_nodes: int):
    """Per-node (P, num_nodes + 1) counts of each destination id and their
    exclusive prefix (the start of each destination's run).  A histogram
    (``bincount``), not a ``scatter_add_``: millions of atomic adds into
    P + 1 counters serialize on the card (43 ms at q4_sj's 60 M keys)."""
    P, width = dest.shape[0], num_nodes + 1
    node = torch.arange(P, device=dest.device)[:, None] * width
    counts = torch.bincount((dest + node).reshape(-1),
                            minlength=P * width).reshape(P, width)
    starts = torch.cumsum(counts, dim=1) - counts
    return counts, starts


def _bucket_presorted(keys, mask, owner, num_nodes: int, capacity: int):
    """Bucket key-sorted masked keys (P, n) into (P, P_dst, capacity) rows
    with gathers only: after :func:`_sort_by_key` each destination's keys
    are a contiguous run from ``starts[d]``.  Returns (buckets,
    bucket_mask, (dest_of_key, slot_of_key), src, overflow); ``src`` is the
    (P, P_dst, capacity) gather index of the buckets, reusable for aligned
    payloads."""
    P, n = keys.shape
    dest = torch.where(mask, owner.to(torch.int64), num_nodes)
    counts, starts = _dest_counts(dest, num_nodes)
    pos_in_group = (torch.arange(n, device=keys.device)
                    - torch.gather(starts, 1, dest))
    overflow = ((pos_in_group >= capacity) & (dest < num_nodes)).any()
    slot_of_key = pos_in_group.clamp(max=capacity - 1)
    s = torch.arange(capacity, device=keys.device)
    src = (starts[:, :num_nodes, None] + s).clamp(max=n - 1)
    bucket_mask = s < counts[:, :num_nodes, None].clamp(max=capacity)
    buckets = torch.gather(keys, 1, src.reshape(P, -1)).reshape(src.shape)
    buckets = torch.where(bucket_mask, buckets, 0)
    return buckets, bucket_mask, (dest, slot_of_key), src, overflow


def bucket_by_destination(keys, mask, owner, num_nodes: int, capacity: int):
    """Pack masked keys (P, n) into fixed-capacity per-destination buckets
    in input order (a stable counting sort by destination).

    Returns (buckets (P, P_dst, cap) int32, bucket_mask bool, (dest_of_key,
    slot_of_key) (P, n) each, overflow): masked keys get destination P;
    entries past a full bucket are dropped and set ``overflow``."""
    P, n = keys.shape
    dest = torch.where(mask, owner.to(torch.int64), num_nodes)
    _, starts = _dest_counts(dest, num_nodes)
    order = torch.sort(dest, dim=1, stable=True).indices
    sorted_dest = torch.gather(dest, 1, order)
    pos_in_group = (torch.arange(n, device=keys.device)
                    - torch.gather(starts, 1, sorted_dest))
    overflow = ((pos_in_group >= capacity)
                & (sorted_dest < num_nodes)).any()
    slot = pos_in_group.clamp(max=capacity - 1)
    valid = (sorted_dest < num_nodes) & (pos_in_group < capacity)
    # dropped entries land in a spill column past the P * capacity slots
    flat = torch.where(valid, sorted_dest * capacity + slot,
                       num_nodes * capacity)
    width = num_nodes * capacity + 1
    buckets = torch.zeros((P, width), dtype=keys.dtype, device=keys.device)
    buckets.scatter_(1, flat, torch.gather(keys, 1, order))
    bucket_mask = torch.zeros((P, width), dtype=torch.bool,
                              device=keys.device)
    bucket_mask.scatter_(1, flat, valid)
    shape = (P, num_nodes, capacity)
    dest_of_key = torch.empty_like(sorted_dest).scatter_(1, order,
                                                         sorted_dest)
    slot_of_key = torch.empty_like(slot).scatter_(1, order, slot)
    return (buckets[:, :-1].reshape(shape), bucket_mask[:, :-1].reshape(shape),
            (dest_of_key, slot_of_key), overflow)


# ---------------------------------------------------------------------------
# request/reply exchange for remote lookups (paper §3.2.2 Alternative 1)
# ---------------------------------------------------------------------------


def request_reply(keys, mask, owner, lookup: Callable, *, capacity: int,
                  backend: str = "xla", reply_dtype=None,
                  wire: Optional[WireFormat] = None):
    """The paper's explicit remote request pattern (§3.2.2 Alt-1), for all
    nodes at once:

    1. each node's still-needed keys (P, n) are bucketed by owner,
    2. routed to the owners with a personalized all-to-all,
    3. answered by ``lookup(keys, mask) -> values`` on (P, P * capacity),
    4. and returned by a second all-to-all to each key's original slot.

    On a packed ``wire`` the request buckets are Elias–Fano coded with the
    mask folded in (one request collective instead of two) and boolean
    replies travel back as bitsets.  Returns (replies aligned with
    ``keys``, overflow flag)."""
    P = keys.shape[0]
    wf = wire or WireFormat.raw()
    order = None
    if wf.packed:
        order, keys, mask, owner = _sort_by_key(keys, mask, owner)
        buckets, bucket_mask, (dest_of_key, slot_of_key), _, overflow = (
            _bucket_presorted(keys, mask, owner, P, capacity))
        msg = encode_key_buckets(buckets, bucket_mask, wf)
        del buckets, bucket_mask       # the largest temporaries (q4_sj)
        req, req_mask = decode_key_buckets(all_to_all(msg, backend=backend),
                                           capacity, wf)
    else:
        buckets, bucket_mask, (dest_of_key, slot_of_key), overflow = (
            bucket_by_destination(keys, mask, owner, P, capacity))
        req = all_to_all(buckets, backend=backend)
        req_mask = all_to_all(bucket_mask, backend=backend)
    replies = lookup(req.reshape(P, P * capacity),
                     req_mask.reshape(P, P * capacity))
    if reply_dtype is not None:
        replies = replies.to(reply_dtype)
    replies = replies.reshape(P, P, capacity)
    if wf.packed and replies.dtype == torch.bool:
        folded = ops.mask_fold(replies.reshape(P * P, capacity))
        back_words = all_to_all(folded.reshape(P, P, -1), backend=backend)
        back = ops.mask_unfold(back_words.reshape(P * P, -1), n=capacity)
    else:
        back = all_to_all(replies, backend=backend)
    # each key's reply sits at (its destination, its slot); masked keys
    # point at the clamped last destination and are zeroed
    at = dest_of_key.clamp(max=P - 1) * capacity + slot_of_key
    out = torch.gather(back.reshape(P, P * capacity), 1, at)
    out = torch.where(mask, out, torch.zeros_like(out))
    if order is not None:
        out = torch.empty_like(out).scatter_(1, order, out)  # undo the sort
    return out, overflow


# ---------------------------------------------------------------------------
# scatter-to-owner exchange (route values to the node owning their key)
# ---------------------------------------------------------------------------


def exchange_by_owner(keys, values, mask, owner, *, capacity: int,
                      backend: str = "xla",
                      wire: Optional[WireFormat] = None):
    """Route each node's masked (key, value) pairs (P, n) to the owner of
    the key (a group-by key on a remote join path: paper Q2, Q13).

    On a packed ``wire`` with a 4-byte value type the Elias–Fano key rows
    (mask folded in) and the value buckets, bit for bit, travel as one
    word row: one all-to-all instead of three, and each sender's slots
    arrive sorted by key (callers scatter by the received keys).  Returns
    (recv_keys, recv_values, recv_mask, overflow); the first three are
    (P_dst, P_src, capacity): what each node received from each sender."""
    P = keys.shape[0]
    wf = wire or WireFormat.raw()
    if wf.packed and values.element_size() == 4:
        _, keys, mask, values, owner = _sort_by_key(keys, mask, values,
                                                    owner)
        buckets, bucket_mask, _, src, overflow = _bucket_presorted(
            keys, mask, owner, P, capacity)
        # the value rows ride the key buckets' gather index
        vals = torch.gather(values, 1, src.reshape(P, -1)).reshape(src.shape)
        vals = torch.where(bucket_mask, vals, torch.zeros_like(vals))
        msg = torch.cat([encode_key_buckets(buckets, bucket_mask, wf),
                         vals.view(torch.int32)], dim=2)
        del buckets, bucket_mask, vals
        recv = all_to_all(msg, backend=backend)
        recv_keys, recv_mask = decode_key_buckets(
            recv[..., :-capacity].contiguous(), capacity, wf)
        recv_vals = recv[..., -capacity:].contiguous().view(values.dtype)
        recv_vals = torch.where(recv_mask, recv_vals,
                                torch.zeros_like(recv_vals))
        return recv_keys, recv_vals, recv_mask, overflow
    buckets, bucket_mask, _, overflow = bucket_by_destination(
        keys, mask, owner, P, capacity)
    # the values take the keys' slots: the bucketing depends on the mask
    # and the owners only
    vbuckets = bucket_by_destination(values, mask, owner, P, capacity)[0]
    recv_keys = all_to_all(buckets, backend=backend)
    recv_vals = all_to_all(vbuckets, backend=backend)
    recv_mask = all_to_all(bucket_mask, backend=backend)
    return recv_keys, recv_vals, recv_mask, overflow
