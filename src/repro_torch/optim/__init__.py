"""Optimizer of the port (counterpart of ``repro.optim``): AdamW, and the
int8 gradient compression with error feedback (``optim/compression.py``),
which, as in the reference, the train step does not call."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    schedule,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState,
    Quantized,
    compress_gradients,
    compression_init,
    decompress_gradients,
)
