"""Optimizer of the port (counterpart of ``repro.optim``): AdamW.  The
JAX package's int8 gradient compression (``optim/compression.py``) is
still to port (ROADMAP.md queue A, item 11.1)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    schedule,
)
