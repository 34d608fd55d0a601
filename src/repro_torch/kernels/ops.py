"""Public entry points of the port's kernels: plans call these only.

Counterpart of ``repro.kernels.ops``.  Dispatch is by device: a CUDA tensor
goes to the hand-written CUDA kernel (which launches or raises — nothing
falls back), a CPU tensor to the plain PyTorch version in ``ref.py``.
``use_kernels(False)`` or ``REPRO_NO_KERNELS=1`` is an explicit choice of
the plain version on every device.

Each CUDA wrapper counts its launches (``launch_counts``), so a run can
show that its path really went through the kernels.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.grouped_agg import filtered_group_sum_cuda
from repro_torch.kernels.scan_filter import scan_filter_cuda
from repro_torch.kernels.wire_codec import (
    ef_decode_cuda,
    ef_encode_cuda,
    mask_fold_cuda,
    mask_unfold_cuda,
)

_FORCE_REF = os.environ.get("REPRO_NO_KERNELS", "0") == "1"
_USE_KERNELS = not _FORCE_REF

_WRAPPERS = {"scan_filter": scan_filter_cuda,
             "filtered_group_sum": filtered_group_sum_cuda,
             "ef_encode": ef_encode_cuda,
             "ef_decode": ef_decode_cuda,
             "mask_fold": mask_fold_cuda,
             "mask_unfold": mask_unfold_cuda}


def use_kernels(enable: bool) -> None:
    global _USE_KERNELS
    _USE_KERNELS = enable and not _FORCE_REF


def _kernel_path(t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return _USE_KERNELS
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def filtered_group_sum(measures, groups, pred, *, cutoff, num_groups):
    """Per-node ``sum(measures[n])`` by group over rows with
    ``pred[n] <= cutoff``: (P, N, C), (P, N), (P, N) -> (P, G, C) f32."""
    if _kernel_path(measures):
        return filtered_group_sum_cuda(measures, groups, pred,
                                       cutoff=cutoff, num_groups=num_groups)
    return ref.filtered_group_sum(measures, groups, pred, cutoff, num_groups)


def scan_filter(words, lo, hi, *, rows, padded_rows, width, negate=False):
    """Validity bitset of ``lo <= code <= hi`` (optionally negated) over
    node-stacked packed words (P, wpn) -> (P, padded_rows / 32) int32;
    rows past ``rows`` are invalid."""
    if _kernel_path(words):
        return scan_filter_cuda(words, lo, hi, rows=rows,
                                padded_rows=padded_rows, width=width,
                                negate=negate)
    return ref.scan_filter(words, lo, hi, rows, padded_rows, width, negate)


def ef_encode(buckets, bucket_mask, base, *, domain):
    """Packed request rows of sorted key buckets: (R, cap) int32 + bool,
    per-row key base (R,) int64 -> (R, packed_request_words) int32."""
    if _kernel_path(buckets):
        return ef_encode_cuda(buckets, bucket_mask, base, domain=domain)
    return ref.ef_encode(buckets, bucket_mask, base, domain)


def ef_decode(words, base, *, capacity, domain):
    """Inverse of :func:`ef_encode`: (R, W) int32 -> (keys (R, capacity)
    int32, mask (R, capacity) bool)."""
    if _kernel_path(words):
        return ef_decode_cuda(words, base, capacity=capacity, domain=domain)
    return ref.ef_decode(words, base, capacity, domain)


def mask_fold(mask):
    """(R, c) bool -> (R, ceil(c/32)) int32 bitset rows."""
    if _kernel_path(mask):
        return mask_fold_cuda(mask)
    return ref.mask_fold(mask)


def mask_unfold(words, *, n):
    """(R, w) int32 bitset rows -> (R, n) bool."""
    if _kernel_path(words):
        return mask_unfold_cuda(words, n)
    return ref.mask_unfold(words, n)
