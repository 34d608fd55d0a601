"""Training of the port (counterpart of ``repro.train``): the train step,
checkpoints, the elastic policy and the trainer loop, on one device or
sharded over a ``DeviceMesh`` of ``torch.distributed`` ranks."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
    train_state_axes,
)
