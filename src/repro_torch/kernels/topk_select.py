"""Per-block top-k kernel (B4): step 1 of the paper's §3.2.3 scheme.

Replaces the TPU kernel ``repro/kernels/topk_select.py:block_topk`` with the
hand-written CUDA kernel ``csrc/topk_select.cu``.  Each row of ``values``
is cut into blocks of ``block`` elements; per block, the k largest values
and their keys in the order k masked-argmax sweeps emit them, ties to the
lowest index (see ``kernels.ref.block_topk`` for the exact semantics).
Leading dimensions are rows, so one launch covers every node of the
node-stacked cluster.

Bound on the H100: bytes for the plans' small k — each value, key and mask
byte read once, ``rows * num_blocks * k * 8`` bytes written.  Design: one
thread block per (row, block), the block staged in shared memory as
order-preserving integer keys, a radix select of the k-th largest key (at
most four histogram passes, whatever k is), a compaction in index order
and a bitonic sort of the k candidates (see the source).  The plain
PyTorch version is ``kernels.ref.block_topk``; dispatch is in
``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_BLOCK = 12288       # 48 KB of keys in shared memory (+ 128 KB of
                        # candidates at k = block)


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("topk_select").repro_block_topk
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_topk_cuda(values: torch.Tensor, keys: torch.Tensor, *, k: int,
                    mask: torch.Tensor | None = None,
                    block: int = 4096) -> tuple:
    """Launch the CUDA kernel.

    values: (..., N) f32; keys: (..., N) int32; mask: (..., N) bool or
    None, all contiguous on one CUDA device.  Returns ((...,
    ceil(N / block), k) f32 values, int32 keys)."""
    if values.device.type != "cuda":
        raise ValueError(f"block_topk_cuda needs CUDA tensors, got "
                         f"{values.device}")
    if values.dtype != torch.float32 or keys.dtype != torch.int32:
        raise ValueError(f"values must be float32 and keys int32, got "
                         f"{values.dtype} and {keys.dtype}")
    shape = tuple(values.shape)
    tensors = (keys,) if mask is None else (keys, mask)
    if values.ndim < 1 or any(tuple(t.shape) != shape
                              or t.device != values.device for t in tensors):
        raise ValueError(f"values, keys and mask must share one shape and "
                         f"device, got {shape}, {tuple(keys.shape)}"
                         + ("" if mask is None else f", {tuple(mask.shape)}"))
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    if not all(t.is_contiguous() for t in (values,) + tensors):
        raise ValueError("values, keys and mask must be contiguous")
    if not 1 <= block <= MAX_BLOCK or not 1 <= k <= block:
        raise ValueError(f"needs 1 <= k <= block <= {MAX_BLOCK}, got k={k}, "
                         f"block={block}")
    n = shape[-1]
    rows = values.numel() // n if n else 0
    nblocks = -(-n // block)
    out_v = torch.empty(shape[:-1] + (nblocks, k), dtype=torch.float32,
                        device=values.device)
    out_k = torch.empty(out_v.shape, dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        err = _lib()(values.data_ptr(), keys.data_ptr(),
                     None if mask is None else mask.data_ptr(),
                     out_v.data_ptr(), out_k.data_ptr(), rows, n, block, k,
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"block_topk kernel launch failed: CUDA error "
                           f"{err}")
    block_topk_cuda.launches += 1
    return out_v, out_k


block_topk_cuda.launches = 0
