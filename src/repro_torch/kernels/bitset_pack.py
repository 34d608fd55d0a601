"""Predicate -> packed bitset kernel (B5): the build side of the paper's
§3.2.2 Alternative 2 semi-join.

Replaces the TPU kernel ``repro/kernels/bitset_pack.py:predicate_bitset``
with the hand-written CUDA kernel ``csrc/bitset_pack.cu``: the packed
bitset of ``column == value``, LSB first, ``ceil(N / 32)`` int32 words per
row (bit-identical to the JAX package's uint32 words), pad bits 0.
Leading dimensions are rows, each packed from bit 0: on node-stacked
``(P, rows_per_node)`` columns that is ``semijoin.alt2_bitset``'s words
per node.

Bound on the H100: bytes — ``4 N`` read and ``N / 8`` written per row.
Design (see the source): a persistent grid whose warps walk (row, tile of
512 columns) pairs, every load of a tile issued before any test, with a
16-byte-load variant where :func:`vector_loads` holds and a scalar one
elsewhere; an input that fits the card in one wave at one word a warp
runs that grid instead.  One launch a call either way.  The plain PyTorch version is
``kernels.ref.predicate_bitset``; dispatch is in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def vector_loads(n: int, data_ptr: int) -> bool:
    """True where the 16-byte-load variant may run on rows of ``n`` int32
    columns starting at ``data_ptr``: every row starts on 16 bytes."""
    return n % 4 == 0 and data_ptr % 16 == 0


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("bitset_pack").repro_predicate_bitset
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def predicate_bitset_cuda(column: torch.Tensor, *, value: int
                          ) -> torch.Tensor:
    """Launch the CUDA kernel.

    column: (..., N) int32, contiguous, on a CUDA device.  Returns (...,
    ceil(N / 32)) int32 words."""
    if column.device.type != "cuda":
        raise ValueError(f"predicate_bitset_cuda needs a CUDA tensor, got "
                         f"{column.device}")
    if column.dtype != torch.int32 or column.ndim < 1:
        raise ValueError(f"column must be int32 with at least one "
                         f"dimension, got {tuple(column.shape)} "
                         f"{column.dtype}")
    if not column.is_contiguous():
        raise ValueError("column must be contiguous")
    value = int(value)
    if not _I32_MIN <= value <= _I32_MAX:
        raise ValueError(f"value {value} outside int32")
    n = column.shape[-1]
    rows = column.numel() // n if n else 0
    out = torch.empty(column.shape[:-1] + ((n + 31) // 32,),
                      dtype=torch.int32, device=column.device)
    with torch.cuda.device(column.device):
        err = _lib()(column.data_ptr(), out.data_ptr(), rows, n, value,
                     int(vector_loads(n, column.data_ptr())),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"predicate_bitset kernel launch failed: CUDA "
                           f"error {err}")
    predicate_bitset_cuda.launches += 1
    return out


predicate_bitset_cuda.launches = 0
