"""Flash-attention backward kernel (B8).

Replaces the TPU kernel
``repro/kernels/flash_attention_bwd.py:flash_attention_bwd`` (its
``_dq_kernel`` and ``_dkv_kernel``) with the hand-written CUDA kernel
``csrc/flash_attention_bwd.cu``: the gradients of the forward (B7) in its
grouped layout, q, out and do (BKV, G, S, D), k and v (BKV, Sk, D), lse
(BKV, G, S) f32 -> dq (BKV, G, S, D), dk and dv (BKV, Sk, D) in the
inputs' dtype, f32 arithmetic, with causal, window and prefix masks and the
TPU kernel's guards (a fully masked row gives zero gradients).  Any S and
Sk.  One call launches three kernels (delta, dq, dk/dv) and counts as one
launch.

Two CUDA variants, chosen as B7's by
``flash_attention.uses_tensor_cores`` from the dtype and head dim alone
(:func:`flash_attention_bwd_gpu`), each with its own launch count:
``csrc/flash_attention_bwd_tc.cu`` (:func:`flash_attention_bwd_tc_cuda`)
for bf16 and f16 with D in {64, 128, 256}, every product on the tensor
cores (wgmma, tiles by TMA), p rounded to the input type before ``p^T do``
and ds before ``ds k`` and ``ds^T q``; and ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd_cuda`) for the rest, in f32 on the CUDA cores.

Bound on the H100: operations, 5 products of ``2 D`` FLOP per visible
(q, k) pair (see the sources for the designs).  The plain PyTorch version
is ``kernels.ref.flash_attention_bwd`` (``p_dtype`` repeats the
tensor-core variant's rounding); dispatch by device, and the
``torch.autograd.Function`` that pairs it with B7, are in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    DTYPES,
    MAX_GROUP,
    MAX_HEAD_DIM,
    TC_DTYPES,
    TC_HEAD_DIMS,
    uses_tensor_cores,
)

_ENTRY = {"flash_attention_bwd": "repro_flash_attention_bwd",
          "flash_attention_bwd_tc": "repro_flash_attention_bwd_tc"}


@functools.cache
def _lib(source: str):
    """The C entry point of ``csrc/<source>.cu``, its signature set once."""
    fn = getattr(build.library(source), _ENTRY[source])
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(qg, kg, vg, out, lse, do, name: str):
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
    if out.shape != qg.shape or do.shape != qg.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must match q {tuple(qg.shape)}")
    if lse.shape != (BKV, G, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({BKV}, {G}, {S}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    tensors = {"k": kg, "v": vg, "out": out, "lse": lse, "do": do}
    if qg.dtype not in DTYPES or any(
            t.dtype != qg.dtype for n, t in tensors.items() if n != "lse"):
        raise ValueError(f"q, k, v, out and do must share one of "
                         f"{list(DTYPES)}, got {qg.dtype}, "
                         f"{[t.dtype for t in tensors.values()]}")
    for n, t in tensors.items():
        if t.device != qg.device:
            raise ValueError(f"{n} is on {t.device}, q on {qg.device}")
    if not all(t.is_contiguous() for t in (qg, *tensors.values())):
        raise ValueError("q, k, v, out, lse and do must be contiguous")
    if D % 4 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if not 1 <= G <= MAX_GROUP or not BKV <= 65535:
        raise ValueError(f"needs 1 <= G <= {MAX_GROUP} and BKV <= 65535, got "
                         f"G={G}, BKV={BKV}")
    return BKV, G, S, Sk, D


def _launch(source, qg, kg, vg, out, lse, do, causal, window, prefix):
    BKV, G, S, D = qg.shape
    Sk = kg.shape[1]
    dq = torch.empty_like(qg)
    dk = torch.empty_like(kg)
    dv = torch.empty_like(vg)
    if BKV == 0:
        return dq, dk, dv
    delta = torch.empty((BKV, G, S), dtype=torch.float32, device=qg.device)
    has_window = window is not None
    with torch.cuda.device(qg.device):
        err = _lib(source)(qg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), DTYPES[qg.dtype], BKV, G, S, Sk, D,
                           int(bool(causal)), int(has_window),
                           int(window) if has_window else 0, int(prefix),
                           1.0 / math.sqrt(D),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{source} kernel launch failed: error {err} (a "
                           f"cudaError_t; 10001 no cuTensorMapEncodeTiled, "
                           f"10002 a tensor map refused)")
    return dq, dk, dv


def flash_attention_bwd_cuda(qg: torch.Tensor, kg: torch.Tensor,
                             vg: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window=None,
                             prefix: int = 0):
    """Launch the f32 CUDA-core kernel (``csrc/flash_attention_bwd.cu``).
    qg, out and do (BKV, G, S, D), kg and vg (BKV, Sk, D), one float dtype,
    D a multiple of 4 up to 256; lse (BKV, G, S) f32; all contiguous, on
    one CUDA device.  Returns (dq, dk, dv)."""
    _check(qg, kg, vg, out, lse, do, "flash_attention_bwd_cuda")
    align = 4 * qg.element_size()
    if any(t.data_ptr() % align for t in (qg, kg, vg, out, do)):
        raise ValueError(f"q, k, v, out and do must be {align}-byte aligned")
    grads = _launch("flash_attention_bwd", qg, kg, vg, out, lse, do, causal,
                    window, prefix)
    flash_attention_bwd_cuda.launches += 1
    return grads


def flash_attention_bwd_tc_cuda(qg: torch.Tensor, kg: torch.Tensor,
                                vg: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, do: torch.Tensor, *,
                                causal: bool = True, window=None,
                                prefix: int = 0):
    """Launch the tensor-core kernel (``csrc/flash_attention_bwd_tc.cu``):
    as :func:`flash_attention_bwd_cuda` for bf16 or f16 with D in {64, 128,
    256}, 16-byte aligned, S and Sk > 0."""
    BKV, G, S, Sk, D = _check(qg, kg, vg, out, lse, do,
                              "flash_attention_bwd_tc_cuda")
    if not uses_tensor_cores(qg.dtype, D):
        raise ValueError(f"the tensor-core kernel takes {TC_DTYPES} with D in "
                         f"{TC_HEAD_DIMS}, got {qg.dtype}, D={D}")
    if S == 0 or Sk == 0 or any(t.data_ptr() % 16
                                for t in (qg, kg, vg, out, do)):
        raise ValueError("needs S, Sk > 0 and 16-byte aligned q, k, v, out "
                         "and do")
    grads = _launch("flash_attention_bwd_tc", qg, kg, vg, out, lse, do,
                    causal, window, prefix)
    flash_attention_bwd_tc_cuda.launches += 1
    return grads


def flash_attention_bwd_gpu(qg, kg, vg, out, lse, do, *, causal=True,
                            window=None, prefix=0):
    """The CUDA variant that ``uses_tensor_cores`` names for these inputs;
    it launches or raises."""
    fn = (flash_attention_bwd_tc_cuda
          if uses_tensor_cores(qg.dtype, qg.shape[-1])
          else flash_attention_bwd_cuda)
    return fn(qg, kg, vg, out, lse, do, causal=causal, window=window,
              prefix=prefix)


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_tc_cuda.launches = 0
