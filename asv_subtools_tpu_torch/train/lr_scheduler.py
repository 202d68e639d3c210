"""Learning-rate schedules (counterpart: asv_subtools_tpu/train/lr_scheduler.py).

Every schedule is a ``step -> lr`` callable in float64, as the JAX
schedules compute under x64. A Python number gives a Python float; a
tensor (the optimizer's ``count`` on the card) gives a float64 tensor on
its device, so the train step reads its learning rate without a host
sync. ``ReduceOnPlateau`` is a host-side object whose ``scale`` the train
step takes as ``lr_scale``.

Names follow the reference's LRSchedulerWrapper: warmR | cyclic | 1cycle |
noam | constant, and reduceP as :class:`ReduceOnPlateau`.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Union

import torch

Step = Union[int, float, torch.Tensor]


def _schedule(fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[Step], Union[float, torch.Tensor]]:
    """Run ``fn`` on the step as a float64 tensor; a number in, a float out."""

    def schedule(step: Step):
        if isinstance(step, torch.Tensor):
            return fn(step.to(torch.float64))
        return float(fn(torch.tensor(float(step), dtype=torch.float64)))

    return schedule


def warm_restarts(base_lr: float, t_0: int, t_mult: int = 1, eta_min: float = 1e-6, factor: float = 1.0,
                  log_decay: bool = False, warmup_steps: int = 0) -> Callable:
    """Cosine annealing with warm restarts (SGDR, "warmR"), with the
    restart peak decayed by ``factor`` per restart, an optional log10-space
    anneal and an optional linear warm-up."""

    def fn(step):
        if t_mult == 1:
            t_cur = torch.remainder(step, t_0)
            t_i = torch.full_like(step, float(t_0))
            n = torch.floor(step / t_0)
        else:
            n = torch.floor(torch.log1p(step * (t_mult - 1) / t_0) / math.log(t_mult))
            start = t_0 * (t_mult ** n - 1) / (t_mult - 1)
            t_cur = step - start
            t_i = t_0 * t_mult ** n
        peak = base_lr * factor ** n
        cos_frac = 0.5 * (1 + torch.cos(math.pi * t_cur / t_i))
        if log_decay:
            log_min = math.log10(eta_min)
            lr = 10 ** (log_min + (torch.log10(peak) - log_min) * cos_frac)
        else:
            lr = eta_min + (peak - eta_min) * cos_frac
        if warmup_steps > 0:
            lr = torch.where(step < warmup_steps, base_lr * (step + 1) / warmup_steps, lr)
        return lr

    return _schedule(fn)


def cyclic(base_lr: float = 1e-8, max_lr: float = 1e-3, step_size_up: int = 2000,
           step_size_down: Optional[int] = None, mode: str = "triangular2", gamma: float = 1.0) -> Callable:
    """CyclicLR (triangular, triangular2 or exp_range), the ECAPA recipe's schedule."""
    down = step_size_down or step_size_up
    total = step_size_up + down

    def fn(step):
        cycle = torch.floor(step / total)
        pos = step - cycle * total
        frac = torch.where(pos < step_size_up, pos / step_size_up, (total - pos) / down)
        amp = torch.full_like(step, max_lr - base_lr)
        if mode == "triangular2":
            amp = amp / 2.0 ** cycle
        elif mode == "exp_range":
            amp = amp * gamma ** step
        return base_lr + amp * frac

    return _schedule(fn)


def one_cycle(max_lr: float = 1e-3, total_steps: int = 100000, pct_start: float = 0.3, div_factor: float = 25.0,
              final_div_factor: float = 1e4) -> Callable:
    """1cycle: cosine up from max_lr/div_factor to max_lr by step
    pct_start*total - 1, then down to the final lr by step total - 1 (torch
    OneCycleLR's phases)."""
    init_lr = max_lr / div_factor
    final_lr = init_lr / final_div_factor
    up = float(total_steps * pct_start) - 1.0
    down = float(total_steps) - up - 1.0

    def cos_anneal(a, b, frac):
        return b + (a - b) * 0.5 * (1 + torch.cos(math.pi * frac))

    def fn(step):
        frac_up = torch.clamp(step / max(up, 1.0), 0.0, 1.0)
        frac_down = torch.clamp((step - up) / max(down, 1.0), 0.0, 1.0)
        return torch.where(step <= up, cos_anneal(init_lr, max_lr, frac_up), cos_anneal(max_lr, final_lr, frac_down))

    return _schedule(fn)


def noam(base_lr: float = 1.0, warmup_steps: int = 25000, step_decay: bool = False, step_size: int = 80000,
         step_rate: float = 0.5, model_dim: Optional[int] = None) -> Callable:
    """wenet's WarmupLR ("noam"): linear warm-up to base_lr, then
    base_lr * warmup^0.5 * s^-0.5 with s = step + 1, or a staircase decay by
    step_rate every step_size steps; ``model_dim`` gives the classic Noam
    peak instead."""
    peak = base_lr
    if model_dim is not None:
        peak = base_lr * model_dim ** -0.5 * warmup_steps ** -0.5

    def fn(step):
        s = step + 1.0
        warm = peak * s / warmup_steps
        if step_decay:
            after = peak * step_rate ** torch.floor((s - warmup_steps) / step_size)
        else:
            after = peak * warmup_steps ** 0.5 * s ** -0.5
        return torch.where(s < warmup_steps, warm, after)

    return _schedule(fn)


def constant(base_lr: float) -> Callable:
    return _schedule(lambda step: torch.full_like(step, base_lr))


class ReduceOnPlateau:
    """Host-side ReduceLROnPlateau ("reduceP"): call ``update(valid_loss)``
    at each validation and pass ``scale`` to the train step as ``lr_scale``."""

    def __init__(self, factor: float = 0.5, patience: int = 2, threshold: float = 1e-4, cooldown: int = 0,
                 min_lr_scale: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr_scale = min_lr_scale
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def update(self, metric: float) -> bool:
        """True if the learning rate was reduced at this update."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
            return False
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
            return False
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_lr_scale)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
            return True
        return False


def get_lr_schedule(name: str = "warmR", **kwargs) -> Callable:
    """A schedule by the reference's name."""
    key = name.lower()
    if key == "warmr":
        return warm_restarts(**kwargs)
    if key == "cyclic":
        return cyclic(**kwargs)
    if key == "1cycle":
        return one_cycle(**kwargs)
    if key == "noam":
        return noam(**kwargs)
    if key == "constant":
        return constant(**kwargs)
    raise ValueError(f"Unknown LR schedule {name!r} (reduceP is ReduceOnPlateau)")


def cycle_end_steps(step_size_up: int, step_size_down: Optional[int], n: int) -> List[int]:
    """Steps at which the first n cyclic cycles end (for cycle-point checkpoints)."""
    total = step_size_up + (step_size_down or step_size_up)
    return [total * (i + 1) for i in range(n)]
