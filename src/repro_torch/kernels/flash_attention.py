"""Flash-attention forward kernel (B7).

Replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_fwd_grouped`` with the
hand-written CUDA kernel ``csrc/flash_attention.cu``: GQA online-softmax
attention in the grouped layout, q (BKV, G, S, D), k and v (BKV, Sk, D) ->
out (BKV, G, S, D) in q's dtype and lse (BKV, G, S) f32, with causal,
window and prefix masks and the TPU kernel's guards (a fully masked row
gives 0).  Any S and Sk.  Its backward is B8
(``flash_attention_bwd.py``); ``kernels.ops`` pairs the two in a
``torch.autograd.Function``.

Two CUDA variants, chosen by :func:`uses_tensor_cores` from the dtype and
head dim alone (:func:`flash_attention_fwd_gpu`), each with its own launch
count: ``csrc/flash_attention_tc.cu`` (:func:`flash_attention_fwd_tc_cuda`)
for bf16 and f16 with D in {64, 128, 256}, its products on the tensor cores
(wgmma, tiles by TMA) and p rounded to the input type before ``p v``; and
``csrc/flash_attention.cu`` (:func:`flash_attention_fwd_cuda`) for the
rest, in f32 on the CUDA cores.

Bound on the H100: operations, ``4 D BKV G S (S + 1) / 2`` FLOP with a
causal mask (see the sources for the designs).  The plain PyTorch version
is ``kernels.ref.flash_attention_fwd`` (``p_dtype`` repeats the
tensor-core variant's rounding); dispatch by device is in
``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
MAX_GROUP = 64          # query heads per kv head (64 query rows a block)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TC_DTYPES = (torch.bfloat16, torch.float16)
TC_HEAD_DIMS = (64, 128, 256)


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Which CUDA variant of B7 and B8 takes inputs of this dtype and head
    dim: the tensor-core kernels exactly for bf16 and f16 with D in
    {64, 128, 256}, the f32 CUDA-core kernels for the rest."""
    return dtype in TC_DTYPES and head_dim in TC_HEAD_DIMS


def group(q, k, v):
    """(B, S, H, D) layout -> GQA-grouped (B*KV, G, S, D) / (B*KV, Sk, D)."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = (q.transpose(1, 2).reshape(B, KV, G, S, D)
          .reshape(B * KV, G, S, D))
    kg = k.transpose(1, 2).reshape(B * KV, Sk, D)
    vg = v.transpose(1, 2).reshape(B * KV, Sk, D)
    return qg, kg, vg


def ungroup(out, B, KV):
    """(B*KV, G, S, D) -> (B, S, KV*G, D)."""
    BKV, G, S, D = out.shape
    return (out.reshape(B, KV, G, S, D).reshape(B, KV * G, S, D)
            .transpose(1, 2))


_ENTRY = {"flash_attention": "repro_flash_attention_fwd",
          "flash_attention_tc": "repro_flash_attention_fwd_tc"}


@functools.cache
def _lib(source: str):
    """The C entry point of ``csrc/<source>.cu``, its signature set once."""
    fn = getattr(build.library(source), _ENTRY[source])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(qg, kg, vg, name: str):
    """Raise on what either CUDA variant does not take; (BKV, G, S, Sk, D)."""
    if qg.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {qg.device}")
    if qg.ndim != 4 or kg.ndim != 3 or vg.shape != kg.shape:
        raise ValueError(f"needs q (BKV, G, S, D) and k, v (BKV, Sk, D), got "
                         f"{tuple(qg.shape)}, {tuple(kg.shape)}, "
                         f"{tuple(vg.shape)}")
    BKV, G, S, D = qg.shape
    Sk = kg.shape[1]
    if kg.shape[0] != BKV or kg.shape[2] != D:
        raise ValueError(f"k {tuple(kg.shape)} does not match q "
                         f"{tuple(qg.shape)}")
    if qg.dtype not in DTYPES or kg.dtype != qg.dtype or vg.dtype != qg.dtype:
        raise ValueError(f"q, k, v must share one of {list(DTYPES)}, got "
                         f"{qg.dtype}, {kg.dtype}, {vg.dtype}")
    for name, t in (("k", kg), ("v", vg)):
        if t.device != qg.device:
            raise ValueError(f"{name} is on {t.device}, q on {qg.device}")
    if not (qg.is_contiguous() and kg.is_contiguous() and vg.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if D % 4 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if not 1 <= G <= MAX_GROUP or not BKV <= 65535:
        raise ValueError(f"needs 1 <= G <= {MAX_GROUP} and BKV <= 65535, got "
                         f"G={G}, BKV={BKV}")
    return BKV, G, S, Sk, D


def _launch(source, qg, kg, vg, causal, window, prefix):
    BKV, G, S, D = qg.shape
    Sk = kg.shape[1]
    out = torch.empty_like(qg)
    lse = torch.empty((BKV, G, S), dtype=torch.float32, device=qg.device)
    if qg.numel() == 0:
        return out, lse
    has_window = window is not None
    with torch.cuda.device(qg.device):
        err = _lib(source)(qg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), DTYPES[qg.dtype],
                           BKV, G, S, Sk, D, int(bool(causal)),
                           int(has_window), int(window) if has_window else 0,
                           int(prefix), 1.0 / math.sqrt(D),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{source} kernel launch failed: error {err} (a "
                           f"cudaError_t; 10001 no cuTensorMapEncodeTiled, "
                           f"10002 a tensor map refused)")
    return out, lse


def flash_attention_fwd_cuda(qg: torch.Tensor, kg: torch.Tensor,
                             vg: torch.Tensor, *, causal: bool = True,
                             window=None, prefix: int = 0):
    """Launch the f32 CUDA-core kernel (``csrc/flash_attention.cu``).  qg
    (BKV, G, S, D), kg and vg (BKV, Sk, D), one float dtype, D a multiple
    of 4 up to 256, contiguous, on one CUDA device.  Returns (out, lse)."""
    _check(qg, kg, vg, "flash_attention_fwd_cuda")
    align = 4 * qg.element_size()
    if any(t.data_ptr() % align for t in (qg, kg, vg)):
        raise ValueError(f"q, k and v must be {align}-byte aligned")
    out, lse = _launch("flash_attention", qg, kg, vg, causal, window, prefix)
    flash_attention_fwd_cuda.launches += 1
    return out, lse


def flash_attention_fwd_tc_cuda(qg: torch.Tensor, kg: torch.Tensor,
                                vg: torch.Tensor, *, causal: bool = True,
                                window=None, prefix: int = 0):
    """Launch the tensor-core kernel (``csrc/flash_attention_tc.cu``): as
    :func:`flash_attention_fwd_cuda` for bf16 or f16 with D in {64, 128,
    256}, 16-byte aligned, Sk > 0."""
    BKV, G, S, Sk, D = _check(qg, kg, vg, "flash_attention_fwd_tc_cuda")
    if not uses_tensor_cores(qg.dtype, D):
        raise ValueError(f"the tensor-core kernel takes {TC_DTYPES} with D in "
                         f"{TC_HEAD_DIMS}, got {qg.dtype}, D={D}")
    if Sk == 0 or any(t.data_ptr() % 16 for t in (qg, kg, vg)):
        raise ValueError("needs Sk > 0 and 16-byte aligned q, k and v")
    out, lse = _launch("flash_attention_tc", qg, kg, vg, causal, window,
                       prefix)
    flash_attention_fwd_tc_cuda.launches += 1
    return out, lse


def flash_attention_fwd_gpu(qg, kg, vg, *, causal=True, window=None,
                            prefix=0):
    """The CUDA variant that :func:`uses_tensor_cores` names for these
    inputs; it launches or raises."""
    fn = (flash_attention_fwd_tc_cuda
          if uses_tensor_cores(qg.dtype, qg.shape[-1])
          else flash_attention_fwd_cuda)
    return fn(qg, kg, vg, causal=causal, window=window, prefix=prefix)


flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_tc_cuda.launches = 0
