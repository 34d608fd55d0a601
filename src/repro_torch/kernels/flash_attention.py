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

Bound on the H100: operations, ``4 D BKV G S (S + 1) / 2`` FLOP with a
causal mask; the kernel computes in f32 on the CUDA cores (see the source
for the design).  The plain PyTorch version is
``kernels.ref.flash_attention_fwd``; dispatch is in ``kernels.ops``.
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


@functools.cache
def _lib():
    """The kernel's C entry point, its signature set once."""
    fn = build.library("flash_attention").repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd_cuda(qg: torch.Tensor, kg: torch.Tensor,
                             vg: torch.Tensor, *, causal: bool = True,
                             window=None, prefix: int = 0):
    """Launch the CUDA kernel.  qg (BKV, G, S, D), kg and vg (BKV, Sk, D),
    one float dtype, contiguous, on one CUDA device.  Returns (out, lse)."""
    if qg.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd_cuda needs CUDA tensors, got "
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
    align = 4 * qg.element_size()
    if any(t.data_ptr() % align for t in (qg, kg, vg)):
        raise ValueError(f"q, k and v must be {align}-byte aligned")
    out = torch.empty_like(qg)
    lse = torch.empty((BKV, G, S), dtype=torch.float32, device=qg.device)
    if qg.numel() == 0:
        return out, lse
    has_window = window is not None
    with torch.cuda.device(qg.device):
        err = _lib()(qg.data_ptr(), kg.data_ptr(), vg.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), DTYPES[qg.dtype], BKV, G,
                     S, Sk, D, int(bool(causal)), int(has_window),
                     int(window) if has_window else 0, int(prefix),
                     1.0 / math.sqrt(D),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0
