"""Single-token decode attention kernel (B9).

Replaces the TPU kernel ``repro/kernels/decode_attention.py:decode_attention``
with the hand-written CUDA kernel ``csrc/decode_attention.cu``: q (BKV, G, D)
f32 or bf16 against caches (BKV, Smax, D), f32, bf16 or int8 with
(BKV, Smax) f32 scales dequantised in the kernel, positions >= ``length``
masked; out (BKV, G, D) in q's dtype.  ``length`` is a 0-d int32 tensor on
the device, read by the kernel (the TPU kernel reads it from SMEM), so a
launch captured in a CUDA graph stays right as the length changes.

Bound on the H100: bytes, the ``length`` cache positions of k and v (codes
and scales) plus q and out.  Design: one launch; a cluster of blocks per
BKV row splits the positions on the device, each block's eight warps stream
their share through a cp.async ring and keep an online softmax, and the
partials merge in a fixed order through distributed shared memory, so the
result repeats bit for bit (see the source).  The plain PyTorch version is
``kernels.ref.decode_attention``; dispatch is in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 3}


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("decode_attention").repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _copy_bytes(row_bytes: int, *tensors) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides a cache row and
    every cache's address."""
    return next(b for b in (16, 8, 4) if row_bytes % b == 0
                and all(t.data_ptr() % b == 0 for t in tensors))


def check_length(length, device) -> None:
    """``length`` must be a 0-d int32 tensor on ``device``: the kernel
    reads it there, and nothing reads it on the host."""
    if not (isinstance(length, torch.Tensor) and length.dim() == 0
            and length.dtype == torch.int32 and length.device == device):
        raise ValueError(
            f"length must be a 0-d int32 tensor on {device}, got "
            + (f"{tuple(length.shape)} {length.dtype} on {length.device}"
               if isinstance(length, torch.Tensor) else type(length).__name__))


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length: torch.Tensor, *,
                          k_scale=None, v_scale=None,
                          config: list | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (one launch).  q (BKV, G, D); caches
    (BKV, Smax, D), one dtype; scales (BKV, Smax) f32 or both None; all
    contiguous on one CUDA device; ``length`` a 0-d int32 tensor there.
    Returns (BKV, G, D).  ``config``, a list, receives the launch's
    [cluster size, warps a block, ring stages, shared bytes a block]."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.ndim != 3 or k_cache.ndim != 3 or v_cache.shape != k_cache.shape:
        raise ValueError(f"needs q (BKV, G, D) and caches (BKV, Smax, D), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    BKV, G, D = q.shape
    Smax = k_cache.shape[1]
    if k_cache.shape[0] != BKV or k_cache.shape[2] != D:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"q must be one of {list(Q_DTYPES)}, got {q.dtype}")
    if k_cache.dtype not in CACHE_DTYPES or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"caches must share one of {list(CACHE_DTYPES)}, got "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("give both scales or neither")
    if k_cache.dtype == torch.int8 and not quant:
        raise ValueError("an int8 cache needs its scales")
    tensors = [q, k_cache, v_cache]
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or tuple(s.shape) != (BKV, Smax):
                raise ValueError(f"{name} must be ({BKV}, {Smax}) float32, "
                                 f"got {tuple(s.shape)} {s.dtype}")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("q, the caches and the scales must be contiguous")
    check_length(length, q.device)
    if D % 4 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if not BKV <= 65535:
        raise ValueError(f"needs BKV <= 65535, got {BKV}")
    for t in tensors:
        if t.data_ptr() % 4 or (t is q and t.data_ptr() % (4 * t.element_size())):
            raise ValueError("q must be aligned to 4 elements, the caches "
                             "and scales to 4 bytes")
    cp = _copy_bytes(D * k_cache.element_size(), k_cache, v_cache)
    out = torch.empty_like(q)
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     k_scale.data_ptr() if quant else None,
                     v_scale.data_ptr() if quant else None,
                     length.data_ptr(), out.data_ptr(), Q_DTYPES[q.dtype],
                     CACHE_DTYPES[k_cache.dtype], BKV, G, Smax, D, cp,
                     1.0 / math.sqrt(D), info,
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    if config is not None:
        config[:] = list(info)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
