"""Support utilities: config merging, logging, seeding (the port's own copy
of asv_subtools_tpu/utils/__init__.py)."""

import logging
import random
import time

import numpy as np

from .params import assign_params_dict, load_yaml, save_yaml, split_params


def set_all_seed(seed: int = 1024) -> None:
    """Seed python, numpy and torch (parity: utils.set_all_seed utils.py:293)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def init_logger(name: str = "asv_subtools_tpu_torch", level: int = logging.INFO):
    """Stdout logger with the reference's formatter shape (launchers :83-91)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s [ %(pathname)s:%(lineno)s - %(funcName)s ] "
                "%(levelname)s %(message)s"
            )
        )
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


class Timer:
    """Context or manual wall-clock timer (parity: utils.Timer
    utils.py:606-613): ``elapse()`` since the last ``reset()``; as a
    context, ``elapsed`` holds the block's seconds."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()

    def elapse(self) -> float:
        return time.perf_counter() - self._start

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *a):
        self.elapsed = self.elapse()


def auto_scale_lr(base_lr: float, world_size: int, base_world: int = 1) -> float:
    """Linear LR scaling with data-parallel width (reference utils.py:438-445)."""
    return base_lr * world_size / base_world


__all__ = ["Timer", "auto_scale_lr", "assign_params_dict", "init_logger", "load_yaml", "save_yaml", "set_all_seed", "split_params"]
