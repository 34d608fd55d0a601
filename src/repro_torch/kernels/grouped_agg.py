"""Fused filter + grouped aggregation kernel (B2).

Replaces the TPU kernel ``repro/kernels/grouped_agg.py:filtered_group_sum``
with the hand-written CUDA kernel ``csrc/grouped_agg.cu``:
``out[p, g, c] = sum_n [pred[p, n] <= cutoff] [groups[p, n] == g]
measures[p, n, c]`` for every node ``p`` of the node-stacked cluster, in
one launch (the node index is a grid dimension).

Bound on the H100: bytes — ``P * N * (4 C + 8) + P * G * C * 4`` bytes over
the memory rate (Q1: 32 B per row).  Design: a first pass of per-block
partial sums, then a fixed-order second pass, so the sums are
deterministic from run to run and no f32 accumulator sums more than
:data:`ROWS_PER_THREAD` rows (see the source).  The first pass keeps each
thread's sums in registers where :func:`uses_registers` says they fit
(Q1's 6 x 6), else in per-thread private slabs of shared memory.  The
plain PyTorch version is ``kernels.ref.filtered_group_sum``; dispatch is
in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_GROUPS = 512        # the lowering's KERNEL_MAX_GROUPS
MAX_MEASURES = 64
ROWS_PER_THREAD = 256   # rows one f32 accumulator sums at most
THREADS = 256           # threads per block, at most
SMEM_DEFAULT = 48 * 1024
REG_MAX_MEASURES = 8    # the register variant: C at most this,
REG_MAX_CELLS = 64      # and G * C at most this
REG_CHUNK = 32_768      # rows of one block partial of the register variant


def uses_registers(num_groups: int, c: int) -> bool:
    """True where the register variant runs: a thread's (G, C) sums and a
    quad of rows' measures (4 C floats) fit its registers."""
    return c <= REG_MAX_MEASURES and num_groups * c <= REG_MAX_CELLS


def launch_shape(n: int, num_groups: int, c: int) -> tuple:
    """(slabs, chunk, nblocks, shared bytes) of the shared-slab variant: as
    many private slabs as fit both THREADS // c threads and the default
    48 KB of shared memory (at least one; one 512 x 64 slab needs 128 KB)."""
    slab_bytes = num_groups * c * 4
    slabs = max(1, min(THREADS // c, SMEM_DEFAULT // slab_bytes))
    chunk = slabs * ROWS_PER_THREAD
    return slabs, chunk, -(-n // chunk), slabs * slab_bytes


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _fn(name: str, argtypes: tuple):
    """A C entry point of ``grouped_agg.cu``, its signature set once."""
    fn = getattr(build.library("grouped_agg"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def filtered_group_sum_cuda(measures: torch.Tensor, groups: torch.Tensor,
                            pred: torch.Tensor, *, cutoff: int,
                            num_groups: int) -> torch.Tensor:
    """Launch the CUDA kernel.

    measures: (P, N, C) f32; groups, pred: (P, N) int32 on one CUDA
    device.  Rows whose group lies outside [0, num_groups) are dropped.
    Returns (P, num_groups, C) f32."""
    if measures.device.type != "cuda":
        raise ValueError(f"filtered_group_sum_cuda needs CUDA tensors, got "
                         f"{measures.device}")
    if measures.dtype != torch.float32 or measures.ndim != 3:
        raise ValueError(f"measures must be (nodes, rows, C) float32, got "
                         f"{tuple(measures.shape)} {measures.dtype}")
    P, n, c = measures.shape
    for name, t in (("groups", groups), ("pred", pred)):
        if t.dtype != torch.int32 or tuple(t.shape) != (P, n):
            raise ValueError(f"{name} must be ({P}, {n}) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != measures.device:
            raise ValueError(f"{name} is on {t.device}, measures on "
                             f"{measures.device}")
    if not (measures.is_contiguous() and groups.is_contiguous()
            and pred.is_contiguous()):
        raise ValueError("measures, groups and pred must be contiguous")
    if not 1 <= num_groups <= MAX_GROUPS or not 1 <= c <= MAX_MEASURES:
        raise ValueError(f"needs 1 <= G <= {MAX_GROUPS} and 1 <= C <= "
                         f"{MAX_MEASURES}, got G={num_groups}, C={c}")
    if not 0 < P <= 65535:
        raise ValueError(f"1..65535 nodes per launch, got {P}")
    cutoff = int(cutoff)
    if not -(2 ** 31) <= cutoff < 2 ** 31:
        raise ValueError(f"cutoff {cutoff} outside int32")
    out = torch.empty((P, num_groups, c), dtype=torch.float32,
                      device=measures.device)
    if n == 0:
        return out.zero_()
    ptrs = (measures.data_ptr(), groups.data_ptr(), pred.data_ptr())
    stream = torch.cuda.current_stream(measures.device).cuda_stream
    if uses_registers(num_groups, c):
        nblocks = -(-n // REG_CHUNK)
        vec = n % 4 == 0 and all(p % 16 == 0 for p in ptrs)
        fn = _fn("repro_filtered_group_sum_registers",
                 (_P,) * 5 + (_I, _LL, _I, _I, _I, _LL, _I, _P))
        tail = (nblocks, vec, stream)
    else:
        slabs, chunk, nblocks, _ = launch_shape(n, num_groups, c)
        fn = _fn("repro_filtered_group_sum",
                 (_P,) * 5 + (_I, _LL, _I, _I, _I, _I, _LL, _I, _P))
        tail = (slabs, chunk, nblocks, stream)
    partial = torch.empty((P, nblocks, num_groups, c), dtype=torch.float32,
                          device=measures.device)
    with torch.cuda.device(measures.device):
        err = fn(*ptrs, partial.data_ptr(), out.data_ptr(), P, n, c,
                 num_groups, cutoff, *tail)
    if err:
        raise RuntimeError(f"filtered_group_sum kernel launch failed: CUDA "
                           f"error {err}")
    filtered_group_sum_cuda.launches += 1
    return out


filtered_group_sum_cuda.launches = 0
