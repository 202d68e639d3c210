"""LR range finder (counterpart: asv_subtools_tpu/train/lr_finder.py;
parity: pytorch/libs/training/lr_finder.py:24-219).

An exponential LR sweep from ``start_lr`` to ``end_lr`` over ``num_steps``
batches, recording (lr, smoothed train loss) per step; the suggestion is
the LR at the steepest descent of the smoothed loss curve. The loss is
read on the host every step (one wait on the card a step) so that the
sweep can stop when the loss diverges.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List

import numpy as np


def run_lr_finder(step_fn: Callable, state: Any, data_iter: Iterable, generator: Any, start_lr: float = 1e-8,
                  end_lr: float = 1.0, num_steps: int = 100, smooth: float = 0.05,
                  diverge_factor: float = 5.0) -> Dict[str, Any]:
    """``step_fn(state, batch, generator, lr) -> (state, metrics with
    "loss")``, with the optimizer's base LR 1.0 so that ``lr`` (the step's
    ``lr_scale``) is the LR. Stops early at a non-finite loss or once the
    smoothed loss exceeds ``diverge_factor`` times its best after step 10.
    Returns {"lrs", "losses" (debiased smoothed), "raw_losses" (each
    step's own), "suggested_lr" (None with 5 points or fewer)}; the JAX
    finder returns all but the raw losses."""
    gamma = (end_lr / start_lr) ** (1.0 / max(num_steps - 1, 1))
    lrs: List[float] = []
    losses: List[float] = []
    raw: List[float] = []
    avg = None
    best = float("inf")
    for i, batch in enumerate(data_iter):
        if i >= num_steps:
            break
        lr = start_lr * gamma ** i
        state, metrics = step_fn(state, batch, generator, lr)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            break
        avg = loss if avg is None else (1 - smooth) * avg + smooth * loss
        debiased = avg / (1 - (1 - smooth) ** (i + 1))
        lrs.append(lr)
        raw.append(loss)
        losses.append(debiased)
        best = min(best, debiased)
        if debiased > diverge_factor * best and i > 10:
            break
    lrs_a = np.asarray(lrs)
    losses_a = np.asarray(losses)
    suggestion = None
    if len(lrs_a) > 5:
        suggestion = float(lrs_a[int(np.argmin(np.gradient(losses_a, np.log(lrs_a))))])
    return {"lrs": lrs_a, "losses": losses_a, "raw_losses": np.asarray(raw), "suggested_lr": suggestion}
