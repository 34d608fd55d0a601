"""Elias–Fano wire-codec kernels (B3): the packed exchange's key buckets and
validity bitsets.

Replaces the TPU kernels of ``repro/kernels/wire_codec.py`` (the lane
kernels ``_mask_fold_kernel``, ``_mask_unfold_kernel``,
``_lower_pack_kernel`` and ``_lower_unpack_kernel`` behind ``_row_call``,
and the jnp code around them in ``ef_encode``/``ef_decode``) with the
hand-written CUDA kernels of ``csrc/wire_codec.cu``.  Each wrapper computes
the whole function of its counterpart in ``repro.kernels.ops``:

  ef_encode    (R, cap) sorted int32 keys + bool mask -> (R, W) words,
               W = ``compression.packed_request_words(cap, domain)``
  ef_decode    (R, W) words -> (R, cap) int32 keys + bool mask
  mask_fold    (R, c) bool -> (R, ceil(c / 32)) words
  mask_unfold  (R, w) words -> (R, n) bool

Rows are node-stacked and flattened; each row carries its own key base
(``base``, (R,) int64): the encoder's row ``src * P + dst`` subtracts
``dst * domain``, the decoder's row ``dst * P + src`` adds it back.  Words
are int32, bit-identical to the JAX package's uint32 words.

Bound on the H100: bytes over the memory rate — for the codec the mask
byte of every slot, the key of every valid slot and the packed row; for
fold/unfold 1 B per column and one bit.  Design notes are in the source.
Each kernel has a 16-byte variant and a scalar one: the wrapper takes the
16-byte variant where :func:`vector_rows` finds every row of its inputs
and outputs on a 16-byte boundary.  The plain PyTorch versions are in
``kernels.ref``; dispatch is in ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import compression
from repro_torch.kernels import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _fn(name: str, argtypes: tuple):
    """A C entry point of ``wire_codec.cu``, its signature set once."""
    fn = getattr(build.library("wire_codec"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_rows(cols: int, *tensors: torch.Tensor) -> bool:
    """True where the 16-byte variant of a kernel may run on rows of
    ``cols`` bool or int32 elements: each tensor starts on 16 bytes and
    ``cols`` is a multiple of 16, so every row does too and a thread's 16
    slots never cross the row's end."""
    return cols % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_base(base: torch.Tensor, rows: int, device):
    _check(base, "base", torch.int64, 1)
    if base.shape[0] != rows or base.device != device:
        raise ValueError(f"base must be ({rows},) on {device}, got "
                         f"{tuple(base.shape)} on {base.device}")


def _codec_params(cap: int, domain: int) -> tuple:
    # int32 keys: domain < 2**31 keeps l <= 27 and every shift below 32
    if cap < 1 or not 1 <= domain < 2 ** 31:
        raise ValueError(f"needs capacity >= 1 and 1 <= domain < 2**31, got "
                         f"capacity {cap}, domain {domain}")
    return compression.ef_params(cap, domain)


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def mask_fold_cuda(mask: torch.Tensor) -> torch.Tensor:
    """(R, c) bool -> (R, ceil(c/32)) int32 bitset rows (bit j of word w
    is column 32 w + j)."""
    _check(mask, "mask", torch.bool, 2)
    rows, cols = mask.shape
    words = compression.bitset_words(cols)
    out = torch.empty((rows, words), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        err = _fn("repro_mask_fold", (_P, _P, _LL, _LL, _LL, _I, _P))(
            mask.data_ptr(), out.data_ptr(), rows, cols, words,
            vector_rows(cols, mask),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mask_fold")
    mask_fold_cuda.launches += 1
    return out


def mask_unfold_cuda(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`mask_fold_cuda`: (R, w) int32 -> (R, n) bool."""
    _check(words, "words", torch.int32, 2)
    rows, in_words = words.shape
    if not 0 <= n <= 32 * in_words:
        raise ValueError(f"n={n} columns need more than {in_words} words")
    out = torch.empty((rows, n), dtype=torch.bool, device=words.device)
    with torch.cuda.device(words.device):
        err = _fn("repro_mask_unfold", (_P, _P, _LL, _LL, _LL, _I, _P))(
            words.data_ptr(), out.data_ptr(), rows, in_words, n,
            vector_rows(n, out),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mask_unfold")
    mask_unfold_cuda.launches += 1
    return out


def ef_encode_cuda(buckets: torch.Tensor, bucket_mask: torch.Tensor,
                   base: torch.Tensor, *, domain: int) -> torch.Tensor:
    """Encode (R, cap) key buckets into packed request rows (R, W) int32.
    The valid keys of each row must be an ascending prefix (what the
    exchange's key sort and bucketing produce); offsets ``key - base``
    outside ``[0, domain)`` are clipped, as in the reference."""
    _check(buckets, "buckets", torch.int32, 2)
    _check(bucket_mask, "bucket_mask", torch.bool, 2)
    rows, cap = buckets.shape
    if tuple(bucket_mask.shape) != (rows, cap) \
            or bucket_mask.device != buckets.device:
        raise ValueError(f"bucket_mask must be ({rows}, {cap}) on "
                         f"{buckets.device}")
    _check_base(base, rows, buckets.device)
    l, uw, lw = _codec_params(cap, domain)
    out = torch.empty((rows, compression.packed_request_words(cap, domain)),
                      dtype=torch.int32, device=buckets.device)
    with torch.cuda.device(buckets.device):
        err = _fn("repro_ef_encode",
                  (_P, _P, _P, _P, _LL, _LL, _LL, _I, _LL, _LL, _I, _P))(
            buckets.data_ptr(), bucket_mask.data_ptr(), base.data_ptr(),
            out.data_ptr(), rows, cap, domain, l, uw, lw,
            vector_rows(cap, buckets, bucket_mask),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ef_encode")
    ef_encode_cuda.launches += 1
    return out


def _check_words(words: torch.Tensor, capacity: int, domain: int) -> tuple:
    """Checks of a decoder input; returns (rows, row_words, l, uw, lw)."""
    _check(words, "words", torch.int32, 2)
    rows, row_words = words.shape
    l, uw, lw = _codec_params(capacity, domain)
    if row_words != compression.packed_request_words(capacity, domain):
        raise ValueError(
            f"rows of {row_words} words; capacity {capacity} and domain "
            f"{domain} need {compression.packed_request_words(capacity, domain)}")
    return rows, row_words, l, uw, lw


def ef_zeros_cuda(words: torch.Tensor, *, capacity: int,
                    domain: int) -> torch.Tensor:
    """The first of :func:`ef_decode_cuda`'s two launches, alone (to time
    it): (R, W) int32 packed rows -> (R, 15) int32 markers, entry v the
    number of the row's keys whose high part is at most v.  Counted in no
    launch counter: the main path runs it inside ``ef_decode_cuda``."""
    rows, row_words, _, uw, _ = _check_words(words, capacity, domain)
    markers = torch.empty((rows, compression.EF_UNIVERSE - 1),
                          dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = _fn("repro_ef_zeros", (_P, _P, _LL, _LL, _LL, _P))(
            words.data_ptr(), markers.data_ptr(), rows, uw, row_words,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ef_zeros")
    return markers


def ef_decode_cuda(words: torch.Tensor, base: torch.Tensor, *,
                   capacity: int, domain: int) -> tuple:
    """Decode packed request rows (R, W) int32 into (keys (R, capacity)
    int32, mask (R, capacity) bool); keys are ``base + offset``, 0 on a
    masked slot."""
    rows, row_words, l, uw, lw = _check_words(words, capacity, domain)
    _check_base(base, rows, words.device)
    keys = torch.empty((rows, capacity), dtype=torch.int32,
                       device=words.device)
    mask = torch.empty((rows, capacity), dtype=torch.bool,
                       device=words.device)
    scratch = torch.empty((rows, compression.EF_UNIVERSE - 1),
                          dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = _fn("repro_ef_decode",
                  (_P, _P, _P, _P, _P, _LL, _LL, _I, _LL, _LL, _LL, _I, _P))(
            words.data_ptr(), base.data_ptr(), scratch.data_ptr(),
            keys.data_ptr(), mask.data_ptr(), rows, capacity, l, uw, lw,
            row_words, vector_rows(capacity, keys, mask),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ef_decode")
    ef_decode_cuda.launches += 1
    return keys, mask


for _w in (mask_fold_cuda, mask_unfold_cuda, ef_encode_cuda, ef_decode_cuda):
    _w.launches = 0
