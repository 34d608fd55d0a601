"""AdamW (counterpart of ``repro.optim.adamw``): decoupled weight decay,
global-norm clipping, linear warmup + cosine decay schedule, f32 moments.

The JAX package maps the update over parameter pytrees and returns new
trees.  The port applies it per tensor in a plain loop and updates the
parameters and the moments IN PLACE (at full width a functional update
would hold a second copy of 13.6 GB of f32 parameters and 27 GB of
moments); the arithmetic and its order are the JAX package's.  A "tree" is
a :class:`torch.nn.Module` (its parameters by sorted name), a dict
(values by sorted key, as ``jax.tree.leaves`` orders them), a list or tuple,
or a tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: object           # a tree like the parameters, f32
    nu: object


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree) -> list:
    """The tensors of a tree, in the JAX package's leaf order."""
    if isinstance(tree, nn.Module):
        return [p for _, p in sorted(tree.named_parameters())]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _zeros_like(tree):
    if isinstance(tree, nn.Module):
        return tree.map(torch.zeros_like)
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(t) for t in tree)
    return torch.zeros_like(tree)


def adamw_init(params) -> AdamWState:
    """Zero moments like the parameters, step 0, on their device."""
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=_zeros_like(params), nu=_zeros_like(params))


def schedule(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (int or int tensor), f32 as in JAX."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their f32 squares, leaf by leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step.  Updates ``params`` and the moments of ``state`` in
    place; returns (params, the new state, metrics ``grad_norm`` and ``lr``,
    0-d tensors on the device)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full((), cfg.b1, device=step.device), stepf)
    b2c = 1 - torch.pow(torch.full((), cfg.b2, device=step.device), stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu), strict=True):
        g = (g * scale).float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        delta += cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                          "lr": lr}
