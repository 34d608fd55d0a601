"""Inter-node communication (paper §3.2.6, §4.2) and its wire codec
(§3.2.1), on the node-stacked cluster.

Counterpart of ``repro.core.exchange`` (collectives, the personalized
all-to-all with both backends, the wire format, ``request_reply``,
``exchange_by_owner`` and ``exchange_vectors_by_owner``, the MoE
dispatch's exchange of token rows).  The
nodes a process holds are stacked on the leading axis of every tensor
(all P in-process, L = P / W on each rank of a process group; see
``engine.Topology``), so a collective is a tensor operation over that
axis, followed, across ranks, by the matching ``torch.distributed`` call:

- ``engine.psum`` and ``allreduce_max/min`` reduce over axis 0, then
  ``all_reduce`` (``allreduce_max`` serves ``topk_approx``;
  ``allreduce_min``, ``broadcast_from`` and ``topk.topk_gather`` have no
  caller in the port's plans yet); ``allgather`` gives every node the
  concatenated operands of all P nodes (``engine.all_gather``);
  ``broadcast_from`` copies one node's row to all (``broadcast`` from
  its rank).
- ``all_to_all(x)`` takes ``(L_src, P_dst, ...)`` to ``(L_dst, P_src,
  ...)``: ``"xla"`` is one transpose copy (one ``all_to_all_single``
  across ranks), ``"one_factor"`` the paper's P-round schedule, where
  round i moves the pair ``u <-> (i - u) mod P`` (a local copy inside a
  rank, a send/recv pair across two).
- ``butterfly_allreduce`` merges in log2 P rounds with partner ``u ^ 2^r``.

Wire formats (:class:`WireFormat`): ``raw`` ships int32 key buckets, a
bool mask and the replies as three all-to-alls; ``packed`` ships each
destination row as one Elias–Fano coded word row with the validity mask
folded in (``kernels.ops.ef_encode``), and boolean replies as bitsets
(``kernels.ops.mask_fold``), so a request/reply round trip is two
all-to-alls.  Packed message row, in 32-bit words::

    [ EF upper bitvector | EF lower bits | mask bitset ]

``all_to_all`` and ``allgather`` count the bytes each node injects (the
operand's bytes over L, the JAX package's per-device operand): read them
with :func:`wire_bytes`, reset them with :func:`reset_wire_bytes`.  Beside
those totals every collective (the all-to-alls, whatever their schedule,
the allgathers, ``engine.psum`` and the other all-reduces, each round's
permutes of the butterfly) appends a program-ordered record of its kind,
bytes per node and label, the counterpart of the collectives the JAX
package parses out of its compiled HLO: read it with
:func:`collective_record`, reset it with :func:`reset_collective_record`.
A rank of a group records what one process records.  EXPLAIN ANALYZE
attributes its all-to-alls to the plan's request semi-joins.  The
overflow flags of the exchanges are reduced across ranks
(``engine.any_across``), so every rank reports what one process reports.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import compression
from repro_torch.core.engine import (  # noqa: F401
    _DIST_CALLS,
    CollectiveInstr,
    Topology,
    all_gather,
    all_reduce,
    any_across,
    cluster_nodes,
    collective_record,
    local_topology,
    node_ids,
    psum,
    record_collective,
    reset_collective_record,
    wire_view,
)
from repro_torch.kernels import ops

INT32_MAX = 2 ** 31 - 1

_BYTES = {"all-to-all": 0, "all-gather": 0}


def wire_bytes() -> dict:
    """Collective kind -> bytes per node since the last reset."""
    return dict(_BYTES)


def reset_wire_bytes() -> None:
    for k in _BYTES:
        _BYTES[k] = 0


def _count(kind: str, x: torch.Tensor, label: str = "") -> None:
    """Count and record a collective over ``x`` (L, ...): bytes a node."""
    _BYTES[kind] += x.numel() * x.element_size() // x.shape[0]
    record_collective(kind, x, label)


# ---------------------------------------------------------------------------
# collectives over the node axis, and across the ranks of a group
# ---------------------------------------------------------------------------


def _exchange_p2p(pairs, topo: Topology) -> None:
    """One batch of point-to-point swaps: each ``(peer node, tag, send,
    recv)`` sends ``send`` to the rank holding the peer node and receives
    its message into ``recv``.  Both sides list a pair under the same tag
    and in the same order, so the batch matches up without deadlock."""
    if not pairs:
        return
    batch = []
    for peer, tag, send, recv in pairs:
        rank = topo.global_rank(topo.rank_of(peer))
        batch += [dist.P2POp(dist.isend, wire_view(send), rank,
                             topo.group, tag),
                  dist.P2POp(dist.irecv, wire_view(recv), rank,
                             topo.group, tag)]
    _DIST_CALLS["batch_isend_irecv"] += 1
    for work in dist.batch_isend_irecv(batch):
        work.wait()


def allreduce_max(x):
    """MPI_Allreduce(MAX) of the per-node operands ``x`` (L, ...) over
    the node axis and the ranks -> (...); a -inf sentinel survives only
    where every node holds it."""
    record_collective("all-reduce", x, "allreduce_max")
    out = x.amax(0)
    topo = local_topology(x.shape[0])
    return out if topo is None else all_reduce(out, "max", topo)


def allreduce_min(x):
    """MPI_Allreduce(MIN) over the node axis and the ranks, as
    :func:`allreduce_max` (+inf sentinels)."""
    record_collective("all-reduce", x, "allreduce_min")
    out = x.amin(0)
    topo = local_topology(x.shape[0])
    return out if topo is None else all_reduce(out, "min", topo)


def allgather(x, *, label: str = ""):
    """MPI_Allgather of the per-node operands ``x`` (L, ...): every node
    receives the concatenation of all P nodes' operands in node order,
    (L, P * ...) — one gathered row, a broadcast view over the L local
    nodes."""
    L = x.shape[0]
    topo = local_topology(L)
    _count("all-gather", x, label)
    flat = x.reshape(1, -1)
    if topo is not None:
        gathered = torch.empty((topo.world * flat.shape[1],),
                               dtype=x.dtype, device=x.device)
        all_gather(gathered, flat.reshape(-1), topo.group)
        flat = gathered.reshape(1, -1)
    return flat.expand(L, flat.shape[1])


def broadcast_from(x, root: int):
    """MPI_Bcast: global node ``root``'s row of ``x`` (L, ...) to every
    node."""
    topo = local_topology(x.shape[0])
    if topo is None:
        return x[root].expand_as(x)
    owner = topo.rank_of(root)
    row = (x[root - topo.node_offset].contiguous() if owner == topo.rank
           else torch.empty_like(x[0]))
    _DIST_CALLS["broadcast"] += 1
    dist.broadcast(wire_view(row), src=topo.global_rank(owner),
                      group=topo.group)
    return row.expand_as(x)


def _all_to_all_ranks(x, topo: Topology):
    """The "xla" all-to-all across W ranks: each rank's (L, P, ...)
    messages, regrouped by destination rank, go through one
    ``all_to_all_single``; returns (L_dst, P_src, ...)."""
    L, P, rest = x.shape[0], x.shape[1], x.shape[2:]
    W = topo.world
    # send[q, s, d]: local source s's message to node q * L + d
    send = x.reshape(L, W, L, *rest).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    _DIST_CALLS["all_to_all_single"] += 1
    dist.all_to_all_single(wire_view(recv), wire_view(send),
                              group=topo.group)
    # recv[q, s, d]: node q * L + s's message to local node d
    return recv.permute(2, 0, 1, *range(3, recv.ndim)).reshape(L, P, *rest)


def _one_factor_ranks(x, topo: Topology):
    """The paper's P-round schedule across W ranks: in round i node u
    swaps with v = (i - u) mod P; a pair inside the rank copies locally,
    a pair across ranks swaps by send/recv (one batch a round)."""
    L, P = x.shape[0], x.shape[1]
    off = topo.node_offset
    out = torch.empty_like(x)
    for i in range(P):
        pairs = []
        for ul in range(L):
            u = off + ul
            v = (i - u) % P
            if topo.rank_of(v) == topo.rank:
                out[v - off, u] = x[ul, v]
            else:   # tagged and ordered alike on both ranks: the pair's
                    # smaller node
                pairs.append((v, min(u, v), x[ul, v].contiguous(),
                              out[ul, v]))
        _exchange_p2p(sorted(pairs, key=lambda p: p[1]), topo)
    return out


def all_to_all(x, *, backend: str = "xla", label: str = ""):
    """Personalized all-to-all: ``x[s, d]`` is local node s's message to
    node d; returns ``y`` with ``y[d, s] = x_global[s, d]`` for the local
    nodes d.

    backend="xla": one transpose copy in-process, one
    ``all_to_all_single`` across ranks.  backend="one_factor": the paper's
    §3.2.6 schedule — P rounds; round i pairs u with v = (i - u) mod P
    (an involution; a node paired with itself copies locally), and every
    pair swaps its two messages (send/recv where the pair spans ranks)."""
    L = x.shape[0]
    topo = local_topology(L)
    P = L if topo is None else topo.num_nodes
    if x.shape[1] != P:
        raise ValueError(f"all_to_all needs (L, P, ...) messages over "
                         f"{P} nodes, got {tuple(x.shape)}")
    if backend not in ("xla", "one_factor"):
        raise ValueError(f"unknown all_to_all backend: {backend}")
    if topo is not None:
        out = (_all_to_all_ranks(x, topo) if backend == "xla"
               else _one_factor_ranks(x, topo))
    elif backend == "xla":
        out = x.transpose(0, 1).contiguous()
    else:
        out = torch.empty_like(x)
        u = torch.arange(P, device=x.device)
        for i in range(P):
            v = (i - u) % P
            # node v receives, from its partner u, the message u -> v
            out[v, u] = x[u, v]
    _count("all-to-all", x, label)
    return out


def butterfly_allreduce(state, merge: Callable):
    """Allreduce with a user-defined merge in log2(P) rounds: round r
    merges each node's state with that of its partner ``u ^ 2^r``
    (recursive doubling); every node ends with the full reduction.
    ``state`` is a tuple of (L, ...) tensors; P must be a power of two.
    Across ranks the rounds with ``2^r < L`` stay on the rank; in the
    others every local node's partner sits at the same local index on
    rank ``rank ^ (2^r / L)``, and the two ranks swap their states."""
    L = state[0].shape[0]
    topo = local_topology(L)
    P = L if topo is None else topo.num_nodes
    if P & (P - 1):
        raise ValueError(f"butterfly requires power-of-two nodes, got {P}")
    u = torch.arange(L, device=state[0].device)
    for r in range(P.bit_length() - 1):
        step = 1 << r
        for s in state:   # one permute of each state tensor a round
            record_collective("collective-permute", s, f"butterfly{r}")
        if step < L:
            other = type(state)(*(s[u ^ step] for s in state))
        else:
            peer = (topo.rank ^ (step // L)) * L
            parts = [(peer, j, s.contiguous(), torch.empty_like(s))
                     for j, s in enumerate(state)]
            _exchange_p2p(parts, topo)
            other = type(state)(*(recv for *_, recv in parts))
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
    """(L_src, P_dst, cap) key buckets -> (L_src, P_dst, W) packed rows.
    Valid keys of each row must be a sorted ascending prefix in the
    destination's range (what :func:`_bucket_presorted` produces)."""
    L, P, cap = buckets.shape
    rows = torch.arange(L * P, device=buckets.device)
    base = (rows % P) * wf.domain                   # destination d's range
    msg = ops.ef_encode(buckets.reshape(L * P, cap),
                        bucket_mask.reshape(L * P, cap), base,
                        domain=wf.domain)
    return msg.reshape(L, P, -1)


def decode_key_buckets(words, capacity: int, wf: WireFormat):
    """Inverse of :func:`encode_key_buckets` on the receivers: (L_dst,
    P_src, W) -> (keys (L_dst, P_src, cap) int32, mask bool)."""
    L, P = words.shape[:2]
    # the receiver's range, once a row: its global node id's
    my_base = node_ids(P, words.device).repeat_interleave(P) * wf.domain
    keys, mask = ops.ef_decode(words.reshape(L * P, -1), my_base,
                               capacity=capacity, domain=wf.domain)
    return (keys.reshape(L, P, capacity), mask.reshape(L, P, capacity))


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
    """Per-node (L, num_nodes + 1) counts of each destination id and their
    exclusive prefix (the start of each destination's run).  A histogram
    (``bincount``), not a ``scatter_add_``: millions of atomic adds into
    P + 1 counters serialize on the card (43 ms at q4_sj's 60 M keys)."""
    L, width = dest.shape[0], num_nodes + 1
    row = torch.arange(L, device=dest.device)[:, None] * width
    counts = torch.bincount((dest + row).reshape(-1),
                            minlength=L * width).reshape(L, width)
    starts = torch.cumsum(counts, dim=1) - counts
    return counts, starts


def _bucket_presorted(keys, mask, owner, num_nodes: int, capacity: int):
    """Bucket key-sorted masked keys (L, n) into (L, P_dst, capacity) rows
    with gathers only: after :func:`_sort_by_key` each destination's keys
    are a contiguous run from ``starts[d]``.  Returns (buckets,
    bucket_mask, (dest_of_key, slot_of_key), src, overflow); ``src`` is the
    (L, P_dst, capacity) gather index of the buckets, reusable for aligned
    payloads; ``overflow`` is reduced across ranks."""
    L, n = keys.shape
    dest = torch.where(mask, owner.to(torch.int64), num_nodes)
    counts, starts = _dest_counts(dest, num_nodes)
    pos_in_group = (torch.arange(n, device=keys.device)
                    - torch.gather(starts, 1, dest))
    overflow = any_across(((pos_in_group >= capacity)
                           & (dest < num_nodes)).any())
    slot_of_key = pos_in_group.clamp(max=capacity - 1)
    s = torch.arange(capacity, device=keys.device)
    src = (starts[:, :num_nodes, None] + s).clamp(max=n - 1)
    bucket_mask = s < counts[:, :num_nodes, None].clamp(max=capacity)
    buckets = torch.gather(keys, 1, src.reshape(L, -1)).reshape(src.shape)
    buckets = torch.where(bucket_mask, buckets, 0)
    return buckets, bucket_mask, (dest, slot_of_key), src, overflow


def bucket_by_destination(keys, mask, owner, num_nodes: int, capacity: int):
    """Pack masked keys (L, n) into fixed-capacity per-destination buckets
    in input order (a stable counting sort by destination).

    Returns (buckets (L, P_dst, cap) int32, bucket_mask bool, (dest_of_key,
    slot_of_key) (L, n) each, overflow): masked keys get destination P;
    entries past a full bucket are dropped and set ``overflow`` (reduced
    across ranks)."""
    L, n = keys.shape
    dest = torch.where(mask, owner.to(torch.int64), num_nodes)
    _, starts = _dest_counts(dest, num_nodes)
    order = torch.sort(dest, dim=1, stable=True).indices
    sorted_dest = torch.gather(dest, 1, order)
    pos_in_group = (torch.arange(n, device=keys.device)
                    - torch.gather(starts, 1, sorted_dest))
    overflow = any_across(((pos_in_group >= capacity)
                           & (sorted_dest < num_nodes)).any())
    slot = pos_in_group.clamp(max=capacity - 1)
    valid = (sorted_dest < num_nodes) & (pos_in_group < capacity)
    # dropped entries land in a spill column past the P * capacity slots
    flat = torch.where(valid, sorted_dest * capacity + slot,
                       num_nodes * capacity)
    width = num_nodes * capacity + 1
    buckets = torch.zeros((L, width), dtype=keys.dtype, device=keys.device)
    buckets.scatter_(1, flat, torch.gather(keys, 1, order))
    bucket_mask = torch.zeros((L, width), dtype=torch.bool,
                              device=keys.device)
    bucket_mask.scatter_(1, flat, valid)
    shape = (L, num_nodes, capacity)
    dest_of_key = torch.empty_like(sorted_dest).scatter_(1, order,
                                                         sorted_dest)
    slot_of_key = torch.empty_like(slot).scatter_(1, order, slot)
    return (buckets[:, :-1].reshape(shape), bucket_mask[:, :-1].reshape(shape),
            (dest_of_key, slot_of_key), overflow)


# ---------------------------------------------------------------------------
# request/reply exchange for remote lookups (paper §3.2.2 Alternative 1)
# ---------------------------------------------------------------------------


def _codec_prediction(capacity: int, P: int, wf: WireFormat):
    """Predicted (encode_ms, decode_ms) of this exchange's packed codec
    under the port's wire calibration (``wirecal.cached``), for the
    observer only, never for the computation; 0.0 on the raw wire (no
    codec runs)."""
    if not wf.packed:
        return 0.0, 0.0
    from repro_torch.core import wirecal  # wirecal imports compression

    return wirecal.predict_codec_ms(int(capacity), int(P), wf.domain,
                                    cal=wirecal.cached())


def request_reply(keys, mask, owner, lookup: Callable, *, capacity: int,
                  backend: str = "xla", reply_dtype=None,
                  wire: Optional[WireFormat] = None, observer=None,
                  label: str = ""):
    """The paper's explicit remote request pattern (§3.2.2 Alt-1), for all
    local nodes at once:

    1. each node's still-needed keys (L, n) are bucketed by owner,
    2. routed to the owners with a personalized all-to-all,
    3. answered by ``lookup(keys, mask) -> values`` on (L, P * capacity),
    4. and returned by a second all-to-all to each key's original slot.

    On a packed ``wire`` the request buckets are Elias–Fano coded with the
    mask folded in (one request collective instead of two) and boolean
    replies travel back as bitsets.  Returns (replies aligned with
    ``keys``, overflow flag).

    With an ``observer`` (an :class:`repro_torch.obs.Observer`) it records
    an ``exchange.request_reply`` event with the exchange's static shape
    and its predicted codec times, and those times in the
    ``exchange.encode_ms`` / ``decode_ms`` histograms; the lowering passes
    one once a lowered plan (the JAX package records once a trace).
    ``label`` names the exchange in the event and the collective record."""
    L = keys.shape[0]
    P = cluster_nodes(L)
    wf = wire or WireFormat.raw()
    if observer is not None:
        enc_ms, dec_ms = _codec_prediction(capacity, P, wf)
        observer.event(
            "exchange.request_reply", cat="exchange", label=label,
            capacity=int(capacity), wire=wf.kind,
            key_bits=int(wf.key_bits), backend=backend,
            collectives=2 if wf.packed else 3,
            encode_ms=enc_ms, decode_ms=dec_ms,
        )
        observer.metrics.histogram("exchange.encode_ms").record(enc_ms)
        observer.metrics.histogram("exchange.decode_ms").record(dec_ms)
    tag = f"request_reply:{label}" if label else "request_reply"
    order = None
    if wf.packed:
        order, keys, mask, owner = _sort_by_key(keys, mask, owner)
        buckets, bucket_mask, (dest_of_key, slot_of_key), _, overflow = (
            _bucket_presorted(keys, mask, owner, P, capacity))
        msg = encode_key_buckets(buckets, bucket_mask, wf)
        del buckets, bucket_mask       # the largest temporaries (q4_sj)
        req, req_mask = decode_key_buckets(
            all_to_all(msg, backend=backend, label=tag), capacity, wf)
    else:
        buckets, bucket_mask, (dest_of_key, slot_of_key), overflow = (
            bucket_by_destination(keys, mask, owner, P, capacity))
        req = all_to_all(buckets, backend=backend, label=tag)
        req_mask = all_to_all(bucket_mask, backend=backend, label=tag)
    replies = lookup(req.reshape(L, P * capacity),
                     req_mask.reshape(L, P * capacity))
    if reply_dtype is not None:
        replies = replies.to(reply_dtype)
    replies = replies.reshape(L, P, capacity)
    if wf.packed and replies.dtype == torch.bool:
        folded = ops.mask_fold(replies.reshape(L * P, capacity))
        back_words = all_to_all(folded.reshape(L, P, -1), backend=backend,
                                label=tag)
        back = ops.mask_unfold(back_words.reshape(L * P, -1), n=capacity)
    else:
        back = all_to_all(replies, backend=backend, label=tag)
    # each key's reply sits at (its destination, its slot); masked keys
    # point at the clamped last destination and are zeroed
    at = dest_of_key.clamp(max=P - 1) * capacity + slot_of_key
    out = torch.gather(back.reshape(L, P * capacity), 1, at)
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
    """Route each node's masked (key, value) pairs (L, n) to the owner of
    the key (a group-by key on a remote join path: paper Q2, Q13).

    On a packed ``wire`` with a 4-byte value type the Elias–Fano key rows
    (mask folded in) and the value buckets, bit for bit, travel as one
    word row: one all-to-all instead of three, and each sender's slots
    arrive sorted by key (callers scatter by the received keys).  Returns
    (recv_keys, recv_values, recv_mask, overflow); the first three are
    (L_dst, P_src, capacity): what each node received from each sender."""
    P = cluster_nodes(keys.shape[0])
    wf = wire or WireFormat.raw()
    if wf.packed and values.element_size() == 4:
        _, keys, mask, values, owner = _sort_by_key(keys, mask, values,
                                                    owner)
        buckets, bucket_mask, _, src, overflow = _bucket_presorted(
            keys, mask, owner, P, capacity)
        # the value rows ride the key buckets' gather index
        vals = torch.gather(values, 1,
                            src.reshape(src.shape[0], -1)).reshape(src.shape)
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


def exchange_vectors_by_owner(keys, vectors, mask, owner, *, capacity: int,
                              backend: str = "xla"):
    """:func:`exchange_by_owner` for vector payloads: route each node's
    masked (key, row) pairs, keys (L, n) and rows (L, n, d), to the owner
    of the key on the raw wire (the MoE dispatch: (expert id, token row)
    to the node holding the expert).  Returns (recv_keys (L, P, cap),
    recv_vectors (L, P, cap, d), recv_mask (L, P, cap), (dest, slot) of
    each input pair (L, n) each, where a masked pair has destination P,
    overflow)."""
    L, n = keys.shape
    P = cluster_nodes(L)
    buckets, bucket_mask, dest_slot, overflow = bucket_by_destination(
        keys, mask, owner, P, capacity)
    # each slot's source pair: the bucketing of the pairs' indices
    src = bucket_by_destination(
        torch.arange(n, device=keys.device).expand(L, n), mask, owner, P,
        capacity)[0].reshape(L, P * capacity)
    d = vectors.shape[-1]
    vbuckets = torch.gather(vectors, 1, src[..., None].expand(-1, -1, d))
    vbuckets = torch.where(bucket_mask.reshape(L, -1, 1), vbuckets,
                           torch.zeros((), dtype=vectors.dtype,
                                       device=vectors.device))
    recv_keys = all_to_all(buckets, backend=backend)
    recv_vecs = all_to_all(vbuckets.reshape(L, P, capacity, d),
                           backend=backend)
    recv_mask = all_to_all(bucket_mask, backend=backend)
    return recv_keys, recv_vecs, recv_mask, dest_slot, overflow
