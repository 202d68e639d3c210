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
from .checkpoint import load_checkpoint, load_transfer, save_checkpoint
from .reporter import Reporter, grab_metric, read_report_csv
from .trainer import (TrainState, Trainer, TrainStepConfig, device_spec_augment, init_train_state, make_eval_step,
                      make_train_step)
from .fd import FDSpeakerNet, init_fd_state, make_fd_train_step
from .lr_finder import run_lr_finder
from .sam import make_sam_train_step

__all__ = [
    "FDSpeakerNet",
    "GradientTransformation",
    "ReduceOnPlateau",
    "Reporter",
    "TrainState",
    "TrainStepConfig",
    "Trainer",
    "constant",
    "cycle_end_steps",
    "cyclic",
    "device_spec_augment",
    "get_lr_schedule",
    "get_optimizer",
    "grab_metric",
    "init_fd_state",
    "init_train_state",
    "load_checkpoint",
    "load_transfer",
    "make_eval_step",
    "make_fd_train_step",
    "make_sam_train_step",
    "make_train_step",
    "no_weight_decay_mask",
    "noam",
    "one_cycle",
    "read_report_csv",
    "run_lr_finder",
    "save_checkpoint",
    "sgd",
    "warm_restarts",
]
