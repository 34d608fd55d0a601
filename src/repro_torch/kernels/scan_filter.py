"""Predicate-on-packed scan kernel (B1): range tests over bit-packed words.

Replaces the TPU kernel ``repro/kernels/scan_filter.py:scan_filter_pallas``
with the hand-written CUDA kernel ``csrc/scan_filter.cu``.  The resident
format packs codes at ``width`` bits into 32-bit words
(``core.columnar.PackedColumn``); 32 consecutive rows occupy exactly
``width`` words from a word boundary.  For each group of 32 rows the kernel
evaluates the code-space predicate ``lo <= code <= hi`` (optionally
negated) and writes one validity-bitset word, so the column is never
expanded to one value per row.

Bound on the H100: bytes — ``P * (words_per_node + padded_rows / 32) * 4``
bytes over the memory rate.  Design: one warp per 32-row group, lane ``j``
extracts code ``j`` and ``__ballot_sync`` assembles the word (see the
source).  The plain PyTorch version, decode-then-compare, is
``kernels.ref.scan_filter``; dispatch is in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def check_shape(padded_rows: int, width: int) -> int:
    """Row groups of 32 for a packed column; validates the layout."""
    if padded_rows % 32:
        raise ValueError("padded_rows must be a multiple of 32")
    if not 1 <= width <= 30:
        raise ValueError("code width must be 1..30 (fits a non-negative "
                         "int32)")
    return padded_rows // 32


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("scan_filter").repro_scan_filter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scan_filter_cuda(words: torch.Tensor, lo: int, hi: int, *, rows: int,
                     padded_rows: int, width: int,
                     negate: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on node-stacked packed words.

    words: (P, padded_rows * width / 32) int32 on a CUDA device.
    Returns (P, padded_rows / 32) int32 validity-bitset words."""
    groups = check_shape(padded_rows, width)
    if words.device.type != "cuda":
        raise ValueError(f"scan_filter_cuda needs a CUDA tensor, got "
                         f"{words.device}")
    if words.dtype != torch.int32 or words.ndim != 2:
        raise ValueError(f"words must be (nodes, words) int32, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.shape[1] != groups * width:
        raise ValueError(f"words per node {words.shape[1]} != "
                         f"padded_rows * width / 32 = {groups * width}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if not 0 <= rows <= padded_rows:
        raise ValueError(f"rows {rows} outside [0, {padded_rows}]")
    if not 0 < words.shape[0] <= 65535:
        raise ValueError(f"1..65535 nodes per launch, got {words.shape[0]}")
    lo, hi = int(lo), int(hi)
    if not (_I32_MIN <= lo <= _I32_MAX and _I32_MIN <= hi <= _I32_MAX):
        raise ValueError(f"code bounds ({lo}, {hi}) outside int32")
    out = torch.empty((words.shape[0], groups), dtype=torch.int32,
                      device=words.device)
    with torch.cuda.device(words.device):
        err = _lib()(words.data_ptr(), out.data_ptr(), words.shape[0],
                     groups, rows, width, lo, hi, int(bool(negate)),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scan_filter kernel launch failed: CUDA error "
                           f"{err}")
    scan_filter_cuda.launches += 1
    return out


scan_filter_cuda.launches = 0
