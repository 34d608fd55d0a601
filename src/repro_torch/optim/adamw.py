"""AdamW (counterpart of ``repro.optim.adamw``): decoupled weight decay,
global-norm clipping, linear warmup + cosine decay schedule, f32 moments.

The JAX package maps the update over parameter pytrees and returns new
trees.  The port applies it per tensor in a plain loop and updates the
parameters and the moments IN PLACE (at full width a functional update
would hold a second copy of 13.6 GB of f32 parameters and 27 GB of
moments); the arithmetic and its order are the JAX package's.  Sharded
leaves (DTensors, ``models.sharding``) are updated on each rank's local
block, and the clipping norm is the norm of the whole gradient: each
leaf's local sum of squares is summed over the mesh dims that shard it.  A "tree" is
a :class:`torch.nn.Module` (its parameters by sorted name), a dict
(values by sorted key, as ``jax.tree.leaves`` orders them), a list or tuple,
or a tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard


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


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank (the same storage), a plain tensor
    as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their f32 squares, leaf by leaf.
    Sharded leaves' local sums are summed over the mesh dims that shard
    them, grouped by those dims (one reduction a group), so a replicated
    block counts once."""
    xs = leaves(tree)
    if not any(isinstance(x, DTensor) for x in xs):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in xs))
    groups: dict = {}             # (mesh, sharded dims) -> local sum
    for x in xs:
        key = (None, ())
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            key = (mesh, tuple(j for j, pl in enumerate(x.placements)
                               if isinstance(pl, Shard) and mesh.size(j) > 1))
        s = torch.sum(torch.square(_local(x).float()))
        groups[key] = groups[key] + s if key in groups else s
    total = 0.0
    for (mesh, dims), s in groups.items():
        for j in dims:
            dist.all_reduce(s, group=mesh.get_group(j))
        total = total + s
    return torch.sqrt(total)


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
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        g = (g * scale).float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        delta += cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                          "lr": lr}
