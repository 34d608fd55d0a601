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

Bound on the H100: operations, 5 products of ``2 D`` FLOP per visible
(q, k) pair; the kernel computes in f32 on the CUDA cores (see the source
for the design).  The plain PyTorch version is
``kernels.ref.flash_attention_bwd``; dispatch, and the
``torch.autograd.Function`` that pairs it with B7, are in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, MAX_GROUP, MAX_HEAD_DIM


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("flash_attention_bwd").repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(qg: torch.Tensor, kg: torch.Tensor,
                             vg: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window=None,
                             prefix: int = 0):
    """Launch the CUDA kernel.  qg, out and do (BKV, G, S, D), kg and vg
    (BKV, Sk, D), one float dtype; lse (BKV, G, S) f32; all contiguous, on
    one CUDA device.  Returns (dq, dk, dv)."""
    if qg.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got "
                         f"{qg.device}")
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
    for name, t in tensors.items():
        if t.device != qg.device:
            raise ValueError(f"{name} is on {t.device}, q on {qg.device}")
    if not all(t.is_contiguous() for t in (qg, *tensors.values())):
        raise ValueError("q, k, v, out, lse and do must be contiguous")
    if D % 4 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if not 1 <= G <= MAX_GROUP or not BKV <= 65535:
        raise ValueError(f"needs 1 <= G <= {MAX_GROUP} and BKV <= 65535, got "
                         f"G={G}, BKV={BKV}")
    align = 4 * qg.element_size()
    if any(t.data_ptr() % align for t in (qg, kg, vg, out, do)):
        raise ValueError(f"q, k, v, out and do must be {align}-byte aligned")
    dq = torch.empty_like(qg)
    dk = torch.empty_like(kg)
    dv = torch.empty_like(vg)
    if BKV == 0:
        return dq, dk, dv
    delta = torch.empty((BKV, G, S), dtype=torch.float32, device=qg.device)
    has_window = window is not None
    with torch.cuda.device(qg.device):
        err = _lib()(qg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                     delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), DTYPES[qg.dtype], BKV, G, S, Sk, D,
                     int(bool(causal)), int(has_window),
                     int(window) if has_window else 0, int(prefix),
                     1.0 / math.sqrt(D),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
