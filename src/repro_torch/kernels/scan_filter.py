"""Predicate-on-packed scan kernel (B1): range tests over bit-packed words.

Replaces the TPU kernel ``repro/kernels/scan_filter.py:scan_filter_pallas``
with the hand-written CUDA kernel ``csrc/scan_filter.cu``.  The resident
format packs codes at ``width`` bits into 32-bit words
(``core.columnar.PackedColumn``); 32 consecutive rows occupy exactly
``width`` words from a word boundary.  For each group of 32 rows the kernel
evaluates the code-space predicate ``lo <= code <= hi`` (optionally
negated) and writes one validity-bitset word, so the column is never
expanded to one value per row.

The bounds are host ints, or int32 tensors on the card that the kernel
reads from device memory, as the TPU kernel reads its ``(1, 2)`` bounds
block: 0-d, or ``(B,)`` for B lanes of bounds (a batch of prepared
bindings), all tested in ONE pass over the words, which writes ``(B, P,
groups)`` bitsets.  The kernel clips each lane's range into ``[0,
2^width)`` on the device.

Bound on the H100: bytes — ``P * (words_per_node + B * padded_rows / 32)
* 4`` bytes over the memory rate.  Design (see the source): the
node-stacked words are one stream of ``P * groups`` groups; a warp loads
32 consecutive groups coalesced into shared memory, each lane extracts
its group's 32 codes with the width a template parameter and tests them
against every lane of bounds, and a persistent grid loads each warp's
next tile before it tests the current one.  The kernel has a
16-byte-load variant and a scalar one: the wrapper takes the 16-byte one
where :func:`vector_loads` holds.  The plain PyTorch version,
decode-then-compare, is ``kernels.ref.scan_filter``; dispatch is in
``kernels.ops``.
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


def vector_loads(data_ptr: int) -> bool:
    """True where the 16-byte-load variant may run on words starting at
    ``data_ptr``: the stream starts on 16 bytes.  Nothing else enters: a
    warp's tile of 32 groups spans ``128 * width`` bytes, a multiple of
    16 at every width, and any node count or group count leaves every
    tile on 16 bytes (the ragged last tile is read word by word)."""
    return data_ptr % 16 == 0


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("scan_filter").repro_scan_filter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_bounds(words: torch.Tensor, lo, hi) -> torch.Tensor:
    """Lanes of bounds as the kernel reads them: int32 tensors ``lo`` and
    ``hi`` of one shape, () or (B,), on the words' device -> (B, 2)
    int32, contiguous (a device-side stack: nothing is read back)."""
    if not (isinstance(lo, torch.Tensor) and isinstance(hi, torch.Tensor)):
        raise ValueError("bounds must be both ints or both tensors")
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise ValueError(f"tensor bounds must be int32, got {lo.dtype} "
                         f"and {hi.dtype}")
    if lo.shape != hi.shape or lo.ndim > 1:
        raise ValueError(f"tensor bounds must share a shape () or (B,), "
                         f"got {tuple(lo.shape)} and {tuple(hi.shape)}")
    if lo.device != words.device or hi.device != words.device:
        raise ValueError(f"tensor bounds must lie on the words' device "
                         f"{words.device}")
    return torch.stack([lo.reshape(-1), hi.reshape(-1)], dim=1)


def scan_filter_cuda(words: torch.Tensor, lo, hi, *, rows: int,
                     padded_rows: int, width: int,
                     negate: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on node-stacked packed words.

    words: (P, padded_rows * width / 32) int32 on a CUDA device; lo, hi:
    ints, or int32 tensors on the same device, 0-d or (B,).  Returns
    (P, padded_rows / 32) int32 validity-bitset words, (B, P,
    padded_rows / 32) for (B,) bounds: one launch whatever B is."""
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
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        bounds = device_bounds(words, lo, hi)
        lanes, lead = bounds.shape[0], tuple(lo.shape)
        ptr, lo, hi = bounds.data_ptr(), 0, 0
    else:
        lo, hi = int(lo), int(hi)
        if not (_I32_MIN <= lo <= _I32_MAX and _I32_MIN <= hi <= _I32_MAX):
            raise ValueError(f"code bounds ({lo}, {hi}) outside int32")
        lanes, lead, ptr = 1, (), None
    out = torch.empty(lead + (words.shape[0], groups), dtype=torch.int32,
                      device=words.device)
    if lanes == 0:
        return out
    with torch.cuda.device(words.device):
        err = _lib()(words.data_ptr(), out.data_ptr(), words.shape[0],
                     groups, rows, width, ptr, lanes, lo, hi,
                     int(bool(negate)), int(vector_loads(words.data_ptr())),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scan_filter kernel launch failed: CUDA error "
                           f"{err}")
    scan_filter_cuda.launches += 1
    return out


scan_filter_cuda.launches = 0
