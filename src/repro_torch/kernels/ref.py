"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro.kernels.ref`` for the kernels this port has.  They
repeat each kernel's arithmetic in straightforward tensor code, on the
node-stacked layout: the CPU path runs them, and ``chip_smoke.py`` holds
every CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import compression


def filtered_group_sum(measures, groups, pred, cutoff, num_groups):
    """One-hot contraction per node: (P, N, C), (P, N), (P, N) ->
    (P, G, C), in the measures' floating dtype (f32 for int inputs).
    Rows whose group lies outside [0, num_groups) match no one-hot row."""
    sel = pred <= cutoff
    ids = torch.arange(num_groups, dtype=groups.dtype, device=groups.device)
    onehot = (groups[:, None, :] == ids[None, :, None]) & sel[:, None, :]
    dtype = (measures.dtype if measures.is_floating_point()
             else torch.float32)
    return torch.matmul(onehot.to(dtype), measures.to(dtype))


def scan_filter(words, lo, hi, rows, padded_rows, width, negate=False):
    """Decode-then-compare version of the predicate-on-packed kernel:
    unpack the full column, apply the code-space range test, pack the
    validity bitset (rows past ``rows`` are never valid).
    words: (P, wpn) int32 -> (P, padded_rows / 32) int32."""
    codes = compression.unpack_bits(words, padded_rows, width)
    ok = (codes >= int(lo)) & (codes <= int(hi))
    if negate:
        ok = ~ok
    ok &= torch.arange(padded_rows, device=words.device) < rows
    return compression.pack_bitset(ok)


# ---------------------------------------------------------------------------
# wire codec (§3.2.1): EF key buckets + folded validity mask
# ---------------------------------------------------------------------------


def mask_fold(mask):
    """(R, c) bool -> (R, ceil(c/32)) int32 bitset rows (bit j of word w is
    column 32 w + j)."""
    pad = (-mask.shape[1]) % 32
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    return compression.pack_bitset(mask)


def mask_unfold(words, n):
    """Inverse of :func:`mask_fold`: (R, w) int32 -> (R, n) bool."""
    return compression.unpack_bitset(words, n)


def ef_encode(buckets, bucket_mask, base, domain):
    """Scatter EF encoder: row r of ``buckets`` holds a sorted ascending
    prefix of keys under ``bucket_mask``, offsets taken from ``base[r]``
    and clipped into ``[0, domain)``.  One upper-bitvector bit per valid
    key at ``(off >> l) + j``, the low bits packed at width l, the mask
    bitset last: (R, ``compression.packed_request_words(cap, domain)``)
    int32."""
    rows, cap = buckets.shape
    l, uw, _ = compression.ef_params(cap, domain)
    offs = buckets.to(torch.int64) - base.to(torch.int64)[:, None]
    offs = torch.where(bucket_mask, offs, 0).clamp(0, domain - 1)
    j = torch.arange(cap, device=buckets.device)
    pos = (offs >> l) + j
    word = torch.where(bucket_mask, pos >> 5, uw)   # masked -> spill column
    bit = torch.where(bucket_mask, 1 << (pos & 31), 0)
    upper = torch.zeros((rows, uw + 1), dtype=torch.int64,
                        device=buckets.device).scatter_add_(1, word, bit)
    del pos, word, bit      # (R, cap) int64 each: 4.3 GB apiece at q4_sj
    parts = [compression.to_i32(upper[:, :uw])]
    if l:
        lo = torch.where(bucket_mask, offs & ((1 << l) - 1), 0)
        parts.append(compression.pack_bits(lo, l))
    parts.append(mask_fold(bucket_mask))
    return torch.cat(parts, dim=1)


def ef_decode(words, base, capacity, domain):
    """Rank/select EF decoder (inverse of :func:`ef_encode`): bit-expand the
    upper bitvector, rank its set bits with one cumsum, scatter each one's
    position to its slot.  Returns (keys (R, capacity) int32 =
    ``base[r] + offset``, 0 on masked slots; mask (R, capacity) bool)."""
    rows = words.shape[0]
    l, uw, lw = compression.ef_params(capacity, domain)
    upper = compression.unpack_bitset(words[:, :uw], uw * 32).to(torch.int64)
    rank = torch.cumsum(upper, dim=1)
    tgt = torch.where(upper.bool(), rank - 1, capacity).clamp(max=capacity)
    posv = torch.arange(uw * 32, device=words.device).expand(rows, -1)
    sel = torch.zeros((rows, capacity + 1), dtype=torch.int64,
                      device=words.device).scatter_add_(1, tgt, posv)
    del upper, rank, tgt    # (R, uw * 32) int64 each
    hi = sel[:, :capacity] - torch.arange(capacity, device=words.device)
    if l:
        lo = compression.unpack_bits(words[:, uw:uw + lw], capacity,
                                     l).to(torch.int64)
    else:
        lo = torch.zeros_like(hi)
    mask = mask_unfold(
        words[:, uw + lw:uw + lw + compression.bitset_words(capacity)],
        capacity)
    keys = base.to(torch.int64)[:, None] + ((hi << l) | lo)
    return torch.where(mask, keys, 0).to(torch.int32), mask
