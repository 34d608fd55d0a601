"""Remote-attribute filters / semi-joins (paper §3.2.2), node-stacked.

Counterpart of ``repro.core.semijoin``.  A query's WHERE clause references
an attribute of a remote relation.  Two alternatives:

Alt-1 (request): after all local filtering, ship the still-needed keys to
their owners; owners answer one bit per key (``exchange.request_reply``).

Alt-2 (bitset): owners evaluate the predicate over their whole partition
and allgather the packed bitset; every node then probes locally.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import compression, exchange
from repro_torch.core.partitioning import RangePartitioning


def alt1_request(keys, mask, part: RangePartitioning,
                 local_predicate: Callable, *, capacity: int,
                 backend: str = "xla", wire=None, observer=None,
                 label: str = ""):
    """Request-based semi-join over (P, n) keys: returns (bits aligned with
    keys, overflow).  ``local_predicate(local_indices, mask) -> bool bits``
    evaluates the remote predicate on the owners' partitions, given
    (P, P * capacity) local row indices.  ``observer`` and ``label`` go to
    :func:`exchange.request_reply`."""
    def lookup(req_keys, req_mask):
        return local_predicate(part.local_index(req_keys), req_mask)

    keys = keys.to(torch.int32)           # the wire carries int32 keys
    bits, overflow = exchange.request_reply(
        keys, mask, part.owner(keys), lookup, capacity=capacity,
        backend=backend, reply_dtype=torch.bool, wire=wire,
        observer=observer, label=label)
    return bits & mask, overflow


def alt2_bitset(local_bits):
    """Bitset-replication semi-join: each node packs the predicate bits of
    its own partition (P, rows), and the (P * w,) words are replicated to
    every node: (P, P * w) int32 covering the global key space, row-major
    by node."""
    pad = (-local_bits.shape[1]) % 32
    if pad:
        local_bits = torch.nn.functional.pad(local_bits, (0, pad))
    return exchange.allgather(compression.pack_bitset(local_bits),
                              label="alt2_bitset")


def probe(global_bitset_words, keys, part: RangePartitioning):
    """Probe the replicated bitset (P, words) for global keys (P, n)."""
    keys = keys.to(torch.int64)
    rows = part.rows_per_node
    padded = rows + ((-rows) % 32)
    bit_index = part.owner(keys) * padded + part.local_index(keys)
    return compression.probe_bitset(global_bitset_words, bit_index)
