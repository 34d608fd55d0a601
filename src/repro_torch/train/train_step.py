"""The train step (counterpart of ``repro.train.train_step``): loss ->
gradients -> AdamW, with optional microbatch accumulation (f32, in the
parameters' ``.grad``).

The JAX step is a pure function that XLA compiles; the port's runs eagerly
and updates the state in place (parameters, moments), so it returns the
same state object with the new step.  Sharded, the state's tensors are
DTensors laid out by :func:`train_state_axes` (``train/trainer.py``), the
batch is the rank's rows, and the step runs under the ambient mesh
(``models.runtime``): it takes the state sharded and returns it so.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, leaves)


class TrainState(NamedTuple):
    params: object        # a trainable Transformer
    opt: AdamWState


def init_train_state(model, seed: int = 0, *, device=None) -> TrainState:
    """Trainable parameters from ``seed`` and zero AdamW moments, on
    ``cuda`` unless the caller names another device."""
    params = model.init(seed, device=device, trainable=True)
    return TrainState(params=params, opt=adamw_init(params))


def train_state_axes(model) -> TrainState:
    """Logical-axes tree of the whole TrainState: the moments mirror the
    parameters, the step is replicated."""
    paxes = model.param_axes()
    return TrainState(params=paxes,
                      opt=AdamWState(step=(), mu=paxes, nu=paxes))


def _split_microbatches(batch: dict, n: int) -> list:
    """n consecutive slices of the batch dimension, as JAX's reshape."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    fwd_kw: dict | None = None):
    """``train_step(state, batch) -> (state, metrics)``: the mean loss of
    the microbatches, its gradients summed in f32 and divided by their
    count, one AdamW update.  ``batch`` holds ``tokens`` and ``labels``
    (B, S) on the parameters' device; metrics are 0-d tensors there."""
    fwd_kw = dict(fwd_kw or {})

    def train_step(state: TrainState, batch):
        params = state.params
        for p in params.parameters():
            p.grad = None
        if microbatches == 1:
            loss = model.loss(params, batch, **fwd_kw)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.opt.step.device)
            for mb in _split_microbatches(batch, microbatches):
                l = model.loss(params, mb, **fwd_kw)
                l.backward()        # accumulates into each f32 .grad
                loss = loss + l.detach()
            loss = loss / microbatches
            for p in params.parameters():
                p.grad.div_(microbatches)
        grads = [p.grad for p in leaves(params)]
        params, opt, metrics = adamw_update(grads, state.opt, params,
                                            opt_cfg)
        for p in params.parameters():
            p.grad = None
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step
