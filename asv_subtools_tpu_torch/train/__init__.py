from .lr_scheduler import (
    ReduceOnPlateau,
    constant,
    cycle_end_steps,
    cyclic,
    get_lr_schedule,
    noam,
    one_cycle,
    warm_restarts,
)
from .optim import GradientTransformation, get_optimizer, no_weight_decay_mask, sgd
from .trainer import TrainState, TrainStepConfig, device_spec_augment, init_train_state, make_train_step

__all__ = [
    "GradientTransformation",
    "ReduceOnPlateau",
    "TrainState",
    "TrainStepConfig",
    "constant",
    "cycle_end_steps",
    "cyclic",
    "device_spec_augment",
    "get_lr_schedule",
    "get_optimizer",
    "init_train_state",
    "make_train_step",
    "no_weight_decay_mask",
    "noam",
    "one_cycle",
    "sgd",
    "warm_restarts",
]
