from cmgan_torch.train.loop import Trainer
from cmgan_torch.train.state import (
    TrainState,
    init_train_state,
    make_disc_lr_schedule,
    make_lr_schedule,
)
from cmgan_torch.train.steps import make_train_steps, pesq_labels_host

__all__ = [
    "TrainState",
    "Trainer",
    "init_train_state",
    "make_disc_lr_schedule",
    "make_lr_schedule",
    "make_train_steps",
    "pesq_labels_host",
]
