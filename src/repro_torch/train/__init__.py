"""Training of the port (counterpart of ``repro.train``): the train step,
checkpoints, the elastic policy and the trainer loop, on one device.
Sharding waits for ROADMAP.md queue A, item 9."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
)
