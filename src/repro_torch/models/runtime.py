"""The ambient (mesh, logical rules) context, and the collectives that run
the model on each rank's local shards (counterpart of
``repro.models.runtime``).

The reference jits the step with the state's shardings and lets GSPMD
insert the collectives; it runs its Pallas kernels inside ``shard_map`` so
that each chip executes a kernel on its local shard (GSPMD would
replicate an opaque kernel's operands).  The port runs eagerly, so the
model code itself runs on local blocks under a mesh, and the collectives
GSPMD would insert are explicit here:

- :func:`local_params`: a layer's parameters, each gathered along its
  FSDP-sharded dims (``embed`` -> ``data``) and kept local along its
  tensor-parallel ones (``heads``, ``kv_heads``, ``mlp``, ``vocab`` ->
  ``model``).  Its gradient is reduce-scattered back over the gathered
  mesh dims that shard the batch, summed over the batch dims that
  replicate the parameter, and cut to the rank's block elsewhere.
- :func:`tp_copy` (the identity, its gradient summed over the
  tensor-parallel dims) before a column-parallel product, :func:`tp_sum`
  (a sum over them, its gradient the identity) after a row-parallel one,
  :func:`batch_sum` over the batch dims (the loss), :func:`tp_max`.
- :func:`tp_offset`: where this rank's vocab block starts.

Without an active mesh every function returns its input: the
one-device path is unchanged.  The step builders set the mesh here: the
trainer (``train/trainer.py``), the serve step and its decode loop
(``serve/engine.py``) and the cells' prefill step (``launch/cells.py``).
Under it ``kernels/ops.py`` runs B7 / B8 and the one-token attention B9
on the local blocks.  A mesh dim of size 1 makes no collective call.
"""
from __future__ import annotations

import contextlib
import contextvars
import types
from collections.abc import Mapping
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, Shard

_CTX: contextvars.ContextVar = contextvars.ContextVar("mesh_rules",
                                                      default=None)

# the logical axes the model's products split across ranks: a parameter
# sharded along one of these stays local, one sharded along any other
# (``embed``: FSDP) is gathered before use
TP_LOGICAL = ("heads", "kv_heads", "mlp", "vocab")


@contextlib.contextmanager
def mesh_rules(mesh, rules=None):
    from repro_torch.models.sharding import DEFAULT_RULES

    token = _CTX.set((mesh, dict(rules or DEFAULT_RULES)))
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> Optional[Tuple]:
    return _CTX.get()


def axes_for(logical: str) -> Tuple[str, ...]:
    """Mesh axes for a logical axis under the current rules (a tuple,
    possibly empty)."""
    ctx = current()
    if ctx is None:
        return ()
    mesh, rules = ctx
    tgt = rules.get(logical)
    if tgt is None:
        return ()
    axes = (tgt,) if isinstance(tgt, str) else tuple(tgt)
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def fused_bkv_spec():
    """Partition-spec entry for the grouped kernels' fused (B*KV) dim:
    batch axes (outer) then kv axes (inner), matching the row-major
    (B, KV) -> B*KV reshape."""
    axes = axes_for("batch") + axes_for("kv_heads")
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def constrain(x, *logical_axes):
    """``sharding.constrain`` under the ambient mesh: a DTensor is
    redistributed to the logical axes' layout, a plain tensor (a rank's
    local block, as the model code makes it) comes back as it is; no-op
    without a mesh."""
    ctx = current()
    if ctx is None:
        return x
    from repro_torch.models.sharding import constrain as _constrain

    mesh, rules = ctx
    return _constrain(x, mesh, *logical_axes, rules=rules)


# ---------------------------------------------------------------------------
# the collectives of the local-block model
# ---------------------------------------------------------------------------


def _dims(names) -> Tuple[int, ...]:
    """The indices of the mesh dims named ``names`` that hold more than
    one rank."""
    mesh = current()[0]
    return tuple(j for j, n in enumerate(mesh.mesh_dim_names)
                 if n in names and mesh.size(j) > 1)


def _tp_dims() -> Tuple[int, ...]:
    axes = {a for name in TP_LOGICAL for a in axes_for(name)}
    if any(set(axes_for(name)) != axes for name in TP_LOGICAL):
        raise ValueError(f"the rules must map {TP_LOGICAL} to the same mesh "
                         f"axes, got {[axes_for(n) for n in TP_LOGICAL]}")
    return _dims(axes)


def _all_reduce(x: torch.Tensor, mesh, dims, op=dist.ReduceOp.SUM):
    x = x.contiguous()
    for j in dims:
        dist.all_reduce(x, op=op, group=mesh.get_group(j))
    return x


# The autograd functions keep the mesh on their node: a backward may run
# outside the context (and on CUDA in autograd's own thread, which does
# not see the context variable).


class _Sum(torch.autograd.Function):
    """Summed over the mesh dims ``dims``; the gradient passes as it is
    (what follows runs the same on every rank of those dims)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _all_reduce(x.clone(), mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """The identity; the gradient is summed over the mesh dims ``dims``."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mesh, ctx.dims), None, None


def tp_copy(x):
    """Enter a tensor-parallel region (before a column-parallel product)."""
    if current() is None or not _tp_dims():
        return x
    return _Copy.apply(x, current()[0], _tp_dims())


def tp_sum(x):
    """Leave a tensor-parallel region (after a row-parallel product)."""
    if current() is None or not _tp_dims():
        return x
    return _Sum.apply(x, current()[0], _tp_dims())


def tp_max(x):
    """The maximum over the tensor-parallel dims (no gradient)."""
    if current() is None or not _tp_dims():
        return x
    return _all_reduce(x.detach().clone(), current()[0], _tp_dims(),
                       dist.ReduceOp.MAX)


def batch_sum(x):
    """Summed over the mesh dims that shard the batch; the gradient passes
    as it is."""
    if current() is None or not _dims(axes_for("batch")):
        return x
    return _Sum.apply(x, current()[0], _dims(axes_for("batch")))


def tp_offset(n_local: int) -> Optional[int]:
    """The first row of this rank's block of a dim split ``n_local`` rows
    a rank over the tensor-parallel dims; None without tensor
    parallelism."""
    if current() is None or not _tp_dims():
        return None
    mesh = current()[0]
    coord = mesh.get_coordinate()
    idx = 0
    for j in _tp_dims():
        idx = idx * mesh.size(j) + coord[j]
    return idx * n_local


def _gather_dim(x, dim: int, group, n: int):
    """All-gather ``x`` along ``dim`` over ``group`` (``n`` ranks)."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter_dim(g, dim: int, group, n: int, rank: int, reduce: bool):
    """This rank's block along ``dim`` of ``g``: summed over ``group``
    (reduce-scatter) when ``reduce``, else cut out."""
    if not reduce:
        c = g.shape[dim] // n
        return g.narrow(dim, rank * c, c)
    gt = g.movedim(dim, 0).contiguous()
    out = torch.empty((gt.shape[0] // n, *gt.shape[1:]), dtype=g.dtype,
                      device=g.device)
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """A parameter's local block -> its FSDP-gathered block.  ``gather``:
    (mesh dim, tensor dim) pairs in mesh order; ``reduce``: the batch mesh
    dims that replicate it; ``batch``: the batch mesh dims."""

    @staticmethod
    def forward(ctx, x, mesh, gather, reduce, batch):
        ctx.mesh, ctx.plan = mesh, (gather, reduce, batch)
        for j, d in reversed(gather):           # the innermost split first
            x = _gather_dim(x, d, mesh.get_group(j), mesh.size(j))
        return x.contiguous() if gather else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, (gather, reduce, batch) = ctx.mesh, ctx.plan
        coord = mesh.get_coordinate()
        g = g.contiguous()
        if reduce:
            g = _all_reduce(g.clone(), mesh, reduce)
        for j, d in gather:                     # the outermost split first
            g = _scatter_dim(g, d, mesh.get_group(j), mesh.size(j),
                             coord[j], j in batch)
        return g.contiguous(), None, None, None, None


def _gather(p: torch.Tensor) -> torch.Tensor:
    """A parameter as the model code uses it under the mesh (a plain
    tensor counts as replicated on every mesh dim)."""
    mesh = current()[0]
    local = p.to_local() if isinstance(p, DTensor) else p
    tp = set(_tp_dims())
    batch = _dims(axes_for("batch"))
    gather, sharded = [], set()
    if isinstance(p, DTensor):
        for j, pl in enumerate(p.placements):
            if isinstance(pl, Shard) and mesh.size(j) > 1:
                sharded.add(j)
                if j not in tp:
                    gather.append((j, pl.dim))
    reduce = tuple(j for j in batch if j not in sharded)
    if not gather and not reduce:
        return local
    return _Gather.apply(local, mesh, tuple(gather), reduce, batch)


class _LocalDict(Mapping):
    """A parameter dict seen under the mesh: each entry gathered
    (:func:`_gather`) on first use, so a part of a layer gathers only the
    weights it reads."""

    def __init__(self, params):
        self._params, self._seen = params, {}

    def __getitem__(self, k):
        if k not in self._seen:
            self._seen[k] = _gather(self._params[k])
        return self._seen[k]

    def __contains__(self, k):
        return k in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)


def local_params(obj):
    """Parameters as the model code uses them: without a mesh ``obj``
    itself; under one, a tensor gathered by :func:`_gather`, a dict (a
    ``ParameterDict``) as a mapping that gathers each entry on first use,
    a list for a ``ModuleList``, and a namespace with the same attribute
    names for any other module.  What is local already comes back as it
    is."""
    if current() is None or obj is None:
        return obj
    if isinstance(obj, torch.Tensor):
        return _gather(obj)
    if isinstance(obj, (dict, nn.ParameterDict)):
        return _LocalDict(obj)
    if isinstance(obj, nn.ModuleList):
        return [local_params(m) for m in obj]
    if isinstance(obj, nn.Module):
        attrs = {n: local_params(m) for n, m in obj.named_children()}
        attrs.update((n, local_params(p))
                     for n, p in obj.named_parameters(recurse=False))
        if getattr(obj, "head", 0) is None:
            attrs["head"] = None
        return types.SimpleNamespace(**attrs)
    return obj


def checkpoint(fn, *args):
    """Non-reentrant ``torch.utils.checkpoint`` of ``fn(*args)`` whose
    recompute in the backward runs under the ambient mesh of the forward
    (autograd may recompute outside the context, or in its own thread)."""
    ctx = current()
    kw = {}
    if ctx is not None:
        kw["context_fn"] = lambda: (contextlib.nullcontext(),
                                    mesh_rules(*ctx))
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
