"""Parameters from the JAX package to the port.

:func:`params_from_jax` takes the JAX parameter tree of the dense family,
as ``repro.models.params.values(model.init(key))`` returns it, with every
leaf already turned into a numpy array by the caller, and returns the
port's :class:`~repro_torch.models.transformer.Transformer` on the CPU.
The stacked ``layers`` axis is split across the module list; every array
keeps its values and dtype (bfloat16 included).
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


def params_from_jax(tree: dict) -> Transformer:
    layers = tree["layers"]
    n = len(next(iter(next(iter(layers.values())).values())))
    out = {name: {k: _tensor(v) for k, v in tree[name].items()}
           for name in ("embedding", "final_norm", "head") if name in tree}
    out["layers"] = [
        {blk: {k: _tensor(v[i]) for k, v in sub.items()}
         for blk, sub in layers.items()}
        for i in range(n)]
    return Transformer(out)
