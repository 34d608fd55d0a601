"""Gradient compression with error feedback (counterpart of
``repro.optim.compression``): the paper's §3.2.1 ("compress what you
ship") applied to the training substrate.

int8 symmetric quantization per leaf with a per-leaf f32 scale; the
quantization residual is carried in an error-feedback buffer and added to
the next step's gradient, preserving convergence (Karimireddy et al.
2019).  Intended use: quantize before the cross-pod reduction (the slow
axis), reduce in int-as-float, dequantize after.  As in the reference,
the train step does not call it.

A tree is nested dicts, lists and tuples of tensors.  The arithmetic is
the reference's in f32, and ``torch.round`` rounds half to even as
``jnp.round`` does, so the int8 codes are the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CompressionState(NamedTuple):
    error: object  # a tree of f32 residuals, like the gradients


class Quantized(NamedTuple):
    """One leaf compressed: int8 codes and their f32 scale (0-d)."""

    q: torch.Tensor
    scale: torch.Tensor


def _map(fn, *trees):
    """``fn`` over the tensor leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)) and not isinstance(t, Quantized):
        out = [_map(fn, *xs) for xs in zip(*trees, strict=True)]
        return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
    return fn(*trees)


def compression_init(grads_like) -> CompressionState:
    """Zero f32 residuals shaped like the gradient tree."""
    return CompressionState(error=_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def _quant(g):
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.to(torch.float32) * scale


class _Step:
    """One leaf's compression: its codes and scale, its residual."""

    __slots__ = ("quantized", "error")

    def __init__(self, quantized: Quantized, error: torch.Tensor):
        self.quantized, self.error = quantized, error


def compress_gradients(grads, state: CompressionState):
    """Returns (a tree of :class:`Quantized`, the new state with the
    residuals)."""
    def one(g, e):
        g = g.to(torch.float32) + e
        q, s = _quant(g)
        return _Step(Quantized(q, s), g - _dequant(q, s))

    steps = _map(one, grads, state.error)
    qtree = _map(lambda st: st.quantized, steps)
    etree = _map(lambda st: st.error, steps)
    return qtree, CompressionState(error=etree)


def decompress_gradients(qtree):
    """The f32 gradient tree of a tree of :class:`Quantized`."""
    return _map(lambda qs: _dequant(qs.q, qs.scale), qtree)
