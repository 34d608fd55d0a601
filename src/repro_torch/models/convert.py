"""Parameters and training state between the JAX package and the port.

:func:`params_from_jax` takes the JAX parameter tree of a model, dense or
MoE (each layer's blocks cross by name, ``mlp`` or ``moe`` alike), as
``repro.models.params.values(model.init(key))`` returns it, with every
leaf already turned into a numpy array by the caller, and returns the
port's :class:`~repro_torch.models.transformer.Transformer` on the CPU.
The stacked ``layers`` axis is split across the module list; every array
keeps its values and dtype (bfloat16 included).  :func:`jax_layout` is the
inverse layout (layers stacked again), and :func:`train_state_from_jax`
carries a whole JAX ``TrainState`` (parameters, AdamW step and moments)
across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Transformer


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":      # numpy's bfloat16 (ml_dtypes)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: dict, *, trainable: bool = False) -> Transformer:
    layers = tree["layers"]
    n = len(next(iter(next(iter(layers.values())).values())))
    out = {name: {k: _tensor(v) for k, v in tree[name].items()}
           for name in ("embedding", "final_norm", "head") if name in tree}
    out["layers"] = [
        {blk: {k: _tensor(v[i]) for k, v in sub.items()}
         for blk, sub in layers.items()}
        for i in range(n)]
    return Transformer(out, trainable)


def jax_layout(params: Transformer) -> dict:
    """The JAX package's tree of ``params``: nested dicts, the layers'
    tensors stacked on a leading (L, ...) axis (new tensors, detached)."""
    t = params.tree()
    out = {name: {k: v.detach() for k, v in t[name].items()}
           for name in ("embedding", "final_norm", "head") if name in t}
    first = t["layers"][0]
    out["layers"] = {
        blk: {k: torch.stack([lp[blk][k].detach() for lp in t["layers"]])
              for k in sub}
        for blk, sub in first.items()}
    return out


def train_state_from_jax(state):
    """A JAX ``TrainState(params, AdamWState(step, mu, nu))`` whose leaves
    the caller turned into numpy arrays -> the port's
    :class:`~repro_torch.train.train_step.TrainState` on the CPU: trainable
    parameters, the step as a 0-d int32 tensor, the moments as frozen
    Transformers."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.train_step import TrainState

    params, (step, mu, nu) = state
    return TrainState(
        params_from_jax(params, trainable=True),
        AdamWState(torch.tensor(np.asarray(step), dtype=torch.int32),
                   params_from_jax(mu), params_from_jax(nu)))
