"""Parameters and training state between the JAX package and the port.

:func:`params_from_jax` takes the JAX parameter tree of a model of any
family the port serves, as ``repro.models.params.values(model.init(key))``
returns it, with every leaf already turned into a numpy array by the
caller, and returns the port's
:class:`~repro_torch.models.transformer.Transformer` on the CPU.  The
stacked ``layers`` axis is split across the module list, through nested
dicts of any depth (a mamba layer mixes arrays with a ``norm`` dict); a
hybrid layer keeps only its live block (``attn_block`` on the attention
layers, ``rec_block`` on the others: the JAX tree stores both, and the
inert one is read by nothing).  An encoder-decoder tree's ``enc_layers``
and ``dec_layers`` are split the same way, its ``enc_pos`` and
``dec_pos`` kept as tensors; a VLM's ``patch_proj`` is one more dict.
Every array keeps its values and dtype (bfloat16 included).
:func:`jax_layout` is the inverse layout (layers stacked again), and
:func:`train_state_from_jax` carries a whole JAX ``TrainState``
(parameters, AdamW step and moments) across.
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


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: nested dicts, every array sliced."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return _tensor(tree[i])


def _leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


_STACKED = ("layers", "enc_layers", "dec_layers")


def params_from_jax(tree: dict, *, trainable: bool = False,
                    cfg=None) -> Transformer:
    """The port's parameters of the JAX tree ``tree``; a hybrid tree
    (layers of ``attn_block`` and ``rec_block``) needs its ``cfg`` to
    tell which block of each layer is live."""
    out = {}
    for name, sub in tree.items():
        if name not in _STACKED:
            out[name] = (_tensor(sub) if not isinstance(sub, dict)
                         else {k: _tensor(v) for k, v in sub.items()})
            continue
        n = len(_leaf(sub))
        if set(sub) == {"attn_block", "rec_block"}:
            if cfg is None or cfg.family != "hybrid":
                raise ValueError("a hybrid tree needs its hybrid cfg")
            from repro_torch.models.hybrid import is_attn_layer

            out[name] = [
                _layer(sub["attn_block" if is_attn_layer(cfg, i)
                           else "rec_block"], i)
                for i in range(n)]
        else:
            out[name] = [_layer(sub, i) for i in range(n)]
    return Transformer(out, trainable)


def jax_layout(params: Transformer) -> dict:
    """The JAX package's tree of ``params``: nested dicts, each list of
    layers' tensors stacked on a leading (L, ...) axis (new tensors,
    detached)."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lp[k] for lp in layers]) for k in layers[0]}
        return torch.stack([t.detach() for t in layers])

    out = {}
    for name, sub in params.tree().items():
        if isinstance(sub, list):
            out[name] = stack(sub)
        elif isinstance(sub, dict):
            out[name] = {k: v.detach() for k, v in sub.items()}
        else:
            out[name] = sub.detach()
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
