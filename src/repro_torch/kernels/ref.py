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
