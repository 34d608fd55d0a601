"""Parameter initialisation with logical sharding axes (counterpart of
``repro.models.params``).

Every parameter is made by :func:`param`, which records a tuple of
LOGICAL axis names beside the tensor (its ``axes`` attribute, which the
``Transformer`` module copies onto the parameter it wraps);
:func:`logical_axes` extracts the parallel tree of axis tuples, and
``repro_torch.models.sharding`` maps logical axes to mesh dims.
:func:`param` makes one tensor by the same init kinds as the JAX
``ParamBuilder`` on an explicit ``torch.Generator``: the numbers differ
from ``jax.random``'s, so tests carry the JAX parameters across with
:func:`repro_torch.models.convert.params_from_jax`.  Without a generator
it makes a tensor on the ``meta`` device, shapes and axes only: the
counterpart of ``jax.eval_shape(init)``.
"""
from __future__ import annotations

import math

import torch


def param(shape, gen: torch.Generator | None, *, axes, init: str = "normal",
          scale: float | None = None, dtype=torch.float32) -> torch.Tensor:
    """One parameter on ``gen``'s device (``meta`` when ``gen`` is None),
    its logical ``axes`` (one name or None a dimension) in its ``axes``
    attribute.

    init: ``normal`` (standard normal times ``scale``, by default
    1/sqrt(fan_in) with fan_in the leading dimension, or the only one),
    ``embed`` (standard normal times ``scale``, default 1), ``ones`` or
    ``zeros``.  Drawn in float32, then cast to ``dtype``."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
    device = gen.device if gen is not None else torch.device("meta")
    if init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=device)
    elif init in ("normal", "embed"):
        if init == "normal":
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            s = (scale if scale is not None
                 else 1.0 / math.sqrt(max(fan_in, 1)))
        else:
            s = scale if scale is not None else 1.0
        v = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device).mul_(s).to(dtype)
    else:
        raise ValueError(f"unknown init kind {init!r}")
    v.axes = tuple(axes)
    return v


def logical_axes(tree):
    """A tree of tensors made by :func:`param` (nested dicts and lists,
    None kept) -> the same tree with each tensor's axes tuple."""
    if isinstance(tree, dict):
        return {k: logical_axes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [logical_axes(v) for v in tree]
    if tree is None:
        return None
    axes = getattr(tree, "axes", None)
    if axes is None:
        raise ValueError(f"a tensor of shape {tuple(tree.shape)} carries no "
                         f"logical axes: it was not made by param()")
    return axes
