"""Logical-axis -> mesh-dim sharding rules (counterpart of
``repro.models.sharding``).

The LM meshes (``launch/mesh.py``) have the reference's axes:
  single pod : (data, model)
  multi-pod  : (pod, data, model)

Rules (MaxText-style), the reference's:
  batch           -> (pod, data)     data parallelism over pods x data rows
  embed / d_model -> data            FSDP: parameter shards gathered per layer
  heads/kv_heads/mlp/vocab/expert -> model   tensor/expert parallelism
  everything else -> replicated

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, or a :class:`MeshShape` (axis names and sizes), so
the production shapes (16, 16) and (2, 16, 16) can be resolved without
512 ranks.
:func:`partition_spec` is the reference's ``resolve``: one entry a tensor
dim (None, a mesh axis or a tuple of them), a ``PartitionSpec``'s
entries.  :func:`resolve` turns it into DTensor placements, one a mesh
dim (``Shard(i)`` or ``Replicate()``), and :class:`Sharding` (a mesh and
its placements) stands where the reference has a ``NamedSharding``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# logical axis -> mesh axis (None = replicated)
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",          # fsdp shard of the d_model dim
    "embed_no_fsdp": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "state": None,
    "conv": None,
    "layers": None,           # the reference's scanned-stack leading axis
}


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]


class Sharding(NamedTuple):
    """A tensor's layout: the mesh and one placement a mesh dim."""

    mesh: object
    placements: tuple


def mesh_shape(mesh) -> dict:
    """name -> size of every axis of ``mesh`` (a ``DeviceMesh`` or a
    :class:`MeshShape`), in mesh order."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def batch_shards(mesh, rules: dict | None = None) -> int:
    """The data-parallel degree: the product of the sizes of the mesh
    axes the batch rule names (``("pod", "data")`` by default; the
    decode-opt layout's ``("data", "model_b")``)."""
    shape = mesh_shape(mesh)
    axes = (rules or DEFAULT_RULES).get("batch") or ()
    n = 1
    for ax in ((axes,) if isinstance(axes, str) else axes):
        n *= shape.get(ax, 1)
    return n


def rules_for(mesh, batch: int, rules: dict | None = None) -> dict:
    """The rules with the batch rule degraded to replication when
    ``batch`` does not divide the data-parallel shards (the reference's
    ``launch/cells._rules_for``, and its serve step's for other rules)."""
    rules = dict(rules or DEFAULT_RULES)
    if batch % max(batch_shards(mesh, rules), 1):
        rules["batch"] = None
    return rules


def partition_spec(axes: Tuple[Optional[str], ...], mesh,
                   rules: dict | None = None) -> tuple:
    """Logical axis tuple -> one entry a tensor dim, valid for ``mesh``
    (the reference's ``resolve``): axes absent from the mesh degrade to
    replicated (``pod`` on a single-pod mesh, everything on a one-device
    mesh)."""
    rules = rules or DEFAULT_RULES
    names = set(mesh_axes(mesh))
    spec = []
    for ax in axes:
        tgt = rules.get(ax) if ax is not None else None
        if isinstance(tgt, tuple):
            tgt = tuple(t for t in tgt if t in names) or None
            if tgt is not None and len(tgt) == 1:
                tgt = tgt[0]
        elif tgt is not None and tgt not in names:
            tgt = None
        spec.append(tgt)
    return tuple(spec)


def placements(spec: tuple, mesh) -> tuple:
    """A partition spec -> one placement a mesh dim: ``Shard(i)`` where
    tensor dim i names the mesh axis, else ``Replicate()``.  A tensor dim
    over several mesh axes is split by them in mesh order (DTensor's
    nesting, the reference's order for ``("pod", "data")``)."""
    out = []
    for name in mesh_axes(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} shards tensor dims {dims} "
                             f"of {spec}: a mesh axis shards one dim")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def resolve(axes: Tuple[Optional[str], ...], mesh,
            rules: dict | None = None) -> tuple:
    """Logical axis tuple -> DTensor placements on ``mesh``."""
    return placements(partition_spec(axes, mesh, rules), mesh)


def _is_axes_leaf(x) -> bool:
    """An axes tuple is a plain tuple of axis names/None: NamedTuple nodes
    (TrainState, KVCache, ...) must not match."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def map_axes(fn, tree):
    """``fn(axes)`` at every axes leaf of nested dicts, lists and
    NamedTuples; other leaves (None, a host count) kept."""
    if _is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_axes(fn, v) for v in tree))
    if isinstance(tree, list):
        return [map_axes(fn, v) for v in tree]
    return tree


def sharding_tree(axes_tree, mesh, rules: dict | None = None):
    """Logical-axes tree -> :class:`Sharding` tree."""
    return map_axes(lambda axes: Sharding(mesh, resolve(axes, mesh, rules)),
                    axes_tree)


def spec_tree(axes_tree, mesh, rules: dict | None = None):
    """Logical-axes tree -> placements tree."""
    return map_axes(lambda axes: resolve(axes, mesh, rules), axes_tree)


def local_block(full: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of ``full`` under ``sharding`` (a view): each
    mesh dim in order cuts its sharded tensor dim into equal chunks and
    keeps the chunk of this rank's coordinate."""
    coord = sharding.mesh.get_coordinate()
    out = full
    for j, pl in enumerate(sharding.placements):
        if not isinstance(pl, Shard):
            continue
        n = sharding.mesh.size(j)
        size = out.shape[pl.dim]
        if size % n:
            raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does not "
                             f"split into {n} equal shards")
        c = size // n
        out = out.narrow(pl.dim, coord[j] * c, c)
    return out


def shard(full: torch.Tensor, sharding: Sharding) -> DTensor:
    """A DTensor of ``full`` (the same value on every rank) laid out by
    ``sharding``: each rank keeps a copy of its block only, nothing is
    sent."""
    local = local_block(full, sharding).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def shard_tree(tree, shardings):
    """:func:`shard` of every tensor of nested dicts and lists (a
    ``Transformer.tree()``), each by its entry of ``shardings``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_tree(v, s) for v, s in zip(tree, shardings,
                                                  strict=True)]
    return shard(tree.detach(), shardings)


def place_state(state, shardings, device):
    """This rank's blocks of an empty decode state: ``state`` made on the
    ``meta`` device (its shapes only), each tensor field's block by its
    entry of ``shardings`` (``sharding_tree(model.decode_state_axes(),
    mesh, rules)``) allocated as zeros on ``device``, plain tensors the
    model code runs on.  The whole state is never allocated."""
    blocks = {}
    for f in state._fields:
        t = getattr(state, f)
        if isinstance(t, torch.Tensor):
            blocks[f] = torch.zeros(local_block(t, getattr(shardings, f)).shape,
                                    dtype=t.dtype, device=device)
    return state._replace(host_length=type(state.host_length)(), **blocks)


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole value of a sharded tensor (every rank must call it), a
    plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def constrain(x, mesh, *axes, rules: dict | None = None):
    """The reference's ``with_sharding_constraint`` by logical axes: a
    DTensor is redistributed to the layout the rules give; a plain tensor
    is the rank's local block already and comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, resolve(tuple(axes), mesh, rules))
