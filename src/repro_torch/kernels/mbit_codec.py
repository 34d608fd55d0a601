"""m-bit partial-sum encoder kernel (B6): the paper's §3.2.5 encoder.

Replaces the TPU kernel ``repro/kernels/mbit_codec.py:encode`` with the
hand-written CUDA kernel ``csrc/mbit_codec.cu``.  Per group of ``group``
consecutive values of a row, ``shift = max(0, bits(max) - m)`` and ``code
= q >> shift``; the codes are packed LSB first at m bits, each row from bit
0 into ``ceil(K m / 32)`` int32 words (bit-identical to the JAX package's
uint32 words).  Unlike the TPU kernel, ``group`` only has to divide the
row: the §3.2.5 plan's per-destination rows at SF 1 over 8 nodes hold
1,250 codes in groups of 2, which end in half a word.  On a 1-D input
whose group holds whole words this is JAX ``ops.mbit_encode``.

Bound on the H100: bytes — 4 B read per value, m / 8 B written per code,
4 B per shift.  Design: one launch.  Rows are cut into segments of
:func:`segment` values, whole groups that start on a word boundary, and
one unit of work takes a segment's maxima, shifts and words: a thread
where the segment holds at most :data:`THREAD_VALUES` values (with 16-byte
loads where its rows lie on 16 bytes), else a warp (see the source).
:func:`variant` picks the unit.  The plain PyTorch version is
``kernels.ref.mbit_encode``; the decoder,
``kernels.ref.mbit_decode_bounds``, stays plain PyTorch on every device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import compression
from repro_torch.kernels import build


def _check_params(K: int, m: int, group: int):
    if m < 1 or 32 % m:
        raise ValueError(f"m={m} must divide 32 (no code straddles a word)")
    if group < 1 or K % group:
        raise ValueError(f"group {group} must divide the row length {K}")
    if K and segment(m, group) > 2 ** 31 - 1:
        raise ValueError(f"group {group} too large for the kernel's int32 "
                         f"offsets within a segment")


THREAD_VALUES = 16   # the largest segment one thread takes
_UNITS = {"warp": 0, "thread": 1, "thread16": 2}


def segment(m: int, group: int) -> int:
    """Values of one unit of work: ``lcm(group, 32 / m)``, whole groups
    that start on a word boundary (a row's last segment ends at the row's
    end, which ``group`` dividing K makes a group boundary)."""
    return math.lcm(group, 32 // m)


def variant(K: int, m: int, group: int, data_ptr: int = 0) -> str:
    """The kernel's unit for rows of K values: ``"thread16"`` (a thread a
    segment, 16-byte loads: K and the segment multiples of 4 and the data
    on 16 bytes, so every segment is), ``"thread"`` (a thread a segment of
    at most THREAD_VALUES values) or ``"warp"`` (a warp a segment)."""
    L = segment(m, group)
    if L > THREAD_VALUES:
        return "warp"
    if L % 4 == 0 and K % 4 == 0 and data_ptr % 16 == 0:
        return "thread16"
    return "thread"


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("mbit_codec").repro_mbit_encode
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mbit_encode_cuda(q: torch.Tensor, *, m: int, group: int) -> tuple:
    """Launch the CUDA kernel.

    q: (..., K) int32 holding uint32 values below 2**31, contiguous, on a
    CUDA device.  Returns (words (..., ceil(K m / 32)) int32, shifts (...,
    K / group) int32)."""
    if q.device.type != "cuda":
        raise ValueError(f"mbit_encode_cuda needs a CUDA tensor, got "
                         f"{q.device}")
    if q.dtype != torch.int32 or q.ndim < 1:
        raise ValueError(f"q must be int32 with at least one dimension, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    K = q.shape[-1]
    _check_params(K, m, group)
    rows = q.numel() // K if K else 0
    words = torch.empty(q.shape[:-1] + (compression.packed_words(K, m),),
                        dtype=torch.int32, device=q.device)
    shifts = torch.empty(q.shape[:-1] + (K // group,), dtype=torch.int32,
                         device=q.device)
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), words.data_ptr(), shifts.data_ptr(), rows,
                     K, m, group, segment(m, group),
                     _UNITS[variant(K, m, group, q.data_ptr())],
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mbit_encode kernel launch failed: CUDA error "
                           f"{err}")
    mbit_encode_cuda.launches += 1
    return words, shifts


mbit_encode_cuda.launches = 0
