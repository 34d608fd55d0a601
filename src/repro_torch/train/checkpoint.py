"""Atomic checkpoints in the JAX package's on-disk format (counterpart of
``repro.train.checkpoint``), so that a checkpoint of either package
restores into the other.

- ``step_XXXXXXXX/arrays.npz`` holds ``leaf_i``, the leaves in JAX's
  order (``jax.tree.flatten``: dict keys sorted, tuples and NamedTuples in
  field order); a :class:`~repro_torch.models.transformer.Transformer`
  counts as its JAX tree, the layers stacked on a leading (L, ...) axis
  (``models.convert.jax_layout``).  ``manifest.json`` holds the step, the
  leaf count and the data state.
- Two-phase commit: write ``step_XXXXXXXX.tmp/``, fsync the manifest,
  rename.  A crash mid-save never shows as a checkpoint.
- All but the last 3 checkpoints are removed after each save.
- A save snapshots the leaves to host memory synchronously and can write
  them on a background thread, so the step loop does not wait for disk.
- Mesh-agnostic: a sharded state (DTensor leaves, ``train/trainer.py``)
  is saved as its full arrays, gathered on every rank and written by one
  (rank 0 of the default group); a restore places each array by the
  shardings of the state it fills, so a checkpoint saved under one mesh
  restores under another (the reference's elastic re-mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models import sharding as SH

from repro_torch.models.convert import jax_layout
from repro_torch.models.transformer import Transformer


def _jax_trees(tree, where):
    """``tree`` with each Transformer replaced by its JAX tree, its
    tensors first gathered whole and copied to ``where`` (``"cpu"`` for a
    snapshot, a copy even of a CPU tensor: the step goes on updating the
    state in place while a save writes in the background; ``"meta"`` for
    the structure alone)."""
    if isinstance(tree, Transformer):
        return jax_layout(tree.map(lambda t: (
            torch.empty(t.shape, dtype=t.dtype, device="meta")
            if where == "meta" else SH.full(t).to(where, copy=True))))
    if isinstance(tree, dict):
        return {k: _jax_trees(v, where) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_jax_trees(x, where) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_trees(x, where) for x in tree)
    return tree


def _flatten(tree) -> list:
    """The leaves of a tree without Transformers, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    if tree is None:
        return []
    return [tree]


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return SH.full(x.detach()).cpu().numpy()
    return np.asarray(x)


def _writer() -> bool:
    """True on the one rank that writes: rank 0 of the default group, or
    the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _copy_into(x: torch.Tensor, host: np.ndarray) -> None:
    """Overwrite ``x`` with ``host`` (its whole value); a DTensor keeps
    its block of it."""
    src = torch.from_numpy(np.array(host))
    with torch.no_grad():
        if isinstance(x, DTensor):
            x.to_local().copy_(SH.local_block(
                src, SH.Sharding(x.device_mesh, x.placements)))
        else:
            x.copy_(src)


class _Stacked(list):
    """The layers' tensors of one stacked leaf of a Transformer."""


def _fill(like, it):
    """Fill ``like`` IN PLACE from the arrays of ``it`` in leaf order:
    each tensor leaf is copied into (a Transformer's stacked leaf into its
    layers' tensors), each other leaf is replaced by its array; every
    array must have the shape of the leaf it fills.  Returns ``like``'s
    structure."""
    if isinstance(like, Transformer):
        t = like.tree()
        targets = {name: t[name] for name in ("embedding", "final_norm",
                                              "head") if name in t}
        targets["layers"] = {
            blk: {k: _Stacked(lp[blk][k] for lp in t["layers"]) for k in sub}
            for blk, sub in t["layers"][0].items()}
        _fill(targets, it)
        return like
    if isinstance(like, dict):
        out = {k: _fill(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_fill(x, it) for x in like))
    if isinstance(like, _Stacked):
        host = next(it)
        _check(host, (len(like), *like[0].shape))
        for x, h in zip(like, host):
            _copy_into(x, h)
        return like
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(x, it) for x in like)
    if like is None:
        return None
    host = next(it)
    _check(host, tuple(like.shape))
    if isinstance(like, torch.Tensor):
        _copy_into(like, host)
        return like
    return host


def _check(host: np.ndarray, shape: tuple):
    if host.shape != tuple(shape):
        raise ValueError(f"shape mismatch {host.shape} vs {tuple(shape)}")


def save(path: str, state, step: int, *, data_state: dict | None = None,
         blocking: bool = True):
    """Two-phase atomic save of a tree of tensors and arrays.  Returns the
    writing thread when not ``blocking``.  Every rank of a sharded state
    must call it (the full arrays are gathered); rank 0 writes, the others
    return None."""
    host_leaves = [_to_host(x) for x in _flatten(_jax_trees(state, "cpu"))]
    if not _writer():
        return None
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"step_{step:08d}.tmp")
    final = os.path.join(path, f"step_{step:08d}")

    def _write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "num_leaves": len(host_leaves),
            "data_state": data_state or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        _gc(path, keep=3)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(path: str, keep: int):
    steps = sorted(
        d for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(path: str, like, step: int | None = None):
    """Restore the checkpoint of ``step`` (default the latest) into
    ``like`` IN PLACE: every tensor of it (a Transformer's too) is
    overwritten, keeping its device and dtype (a DTensor its layout: it
    takes its block of the array); numpy leaves are replaced.  Returns
    (state, step, data_state)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n = len(_flatten(_jax_trees(like, "meta")))
    if manifest["num_leaves"] != n:
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"the state expects {n}: architecture mismatch")
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        state = _fill(like, (arrays[f"leaf_{i}"] for i in range(n)))
    return state, step, manifest["data_state"]
