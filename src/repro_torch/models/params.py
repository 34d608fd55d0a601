"""Parameter initialisation (counterpart of ``repro.models.params``).

The JAX package builds parameter trees with logical axis names for GSPMD;
the port keeps one device and needs no axes.  :func:`param` makes one
tensor by the same init kinds on an explicit ``torch.Generator``: the
numbers differ from ``jax.random``'s, so tests carry the JAX parameters
across with :func:`repro_torch.models.convert.params_from_jax`.
"""
from __future__ import annotations

import math

import torch


def param(shape, gen: torch.Generator, *, init: str = "normal",
          scale: float | None = None, dtype=torch.float32) -> torch.Tensor:
    """One parameter on ``gen``'s device.

    init: ``normal`` (standard normal times ``scale``, by default
    1/sqrt(fan_in) with fan_in the leading dimension, or the only one),
    ``embed`` (standard normal times ``scale``, default 1), ``ones`` or
    ``zeros``.  Drawn in float32, then cast to ``dtype``."""
    device = gen.device
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "normal":
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    elif init == "embed":
        s = scale if scale is not None else 1.0
    else:
        raise ValueError(f"unknown init kind {init!r}")
    v = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return v.mul_(s).to(dtype)
