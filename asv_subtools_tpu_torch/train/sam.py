"""Sharpness-aware minimisation train step (counterpart:
asv_subtools_tpu/train/sam.py; parity:
pytorch/libs/training/trainer_online_sam.py:210-370 and optim.SAM,
optim.py:768-838).

Two passes a step: the gradient g at w (BatchNorm in train mode, its
running statistics kept), the ascent to w + e, the gradient there (BN in
train mode on pass 1's statistics, whatever it assigns thrown away), and
the update of the ORIGINAL weights with the second gradient, clipped by
its global norm as ``min(1, max_change / max(|g2|, 1e-12))``. The ascent
``e`` is ``rho * g / max(|g|, 1e-12)``, or with ``adaptive``
``rho * p^2 * g / max(|p * g|, 1e-12)``. Like the train step it never
waits on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from .optim import GradientTransformation
from .trainer import TrainState, TrainStepConfig, _keep, make_loss_and_grads


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def sam_ascent(params: List[torch.Tensor], grads: List[torch.Tensor], rho: float,
               adaptive: bool) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(SAM's ascent e for each parameter, the norm it divides by): ``rho *
    g / max(|g|, 1e-12)``, or with ``adaptive`` ``rho * p^2 * g / max(|p *
    g|, 1e-12)`` (JAX train/sam.py:73-84)."""
    if adaptive:
        gnorm = global_norm(torch._foreach_mul(torch._foreach_abs(params), grads))
        direction = torch._foreach_mul(torch._foreach_mul(params, params), grads)
    else:
        gnorm = global_norm(grads)
        direction = grads
    return torch._foreach_mul(direction, rho / torch.clamp_min(gnorm, 1e-12)), gnorm


def make_sam_train_step(net: torch.nn.Module, tx: GradientTransformation, rho: float = 0.05,
                        adaptive: bool = False, config: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Build ``step(state, batch, generator, lambda_m=1.0, margin_offset=0.0,
    lr_scale=1.0) -> (state, metrics)``, the train step's signature, on
    feature input (``batch["x"]`` [B, T, D]; the JAX SAM step has no
    in-step front end and no gradient accumulation). metrics: loss (pass
    1), sam_loss (pass 2), accuracy (pass 1), grad_norm (the ascent's
    norm) and skipped; a step whose second loss or gradient norm is not
    finite keeps the old weights, optimizer state and BN statistics."""
    if config.wave_input or config.accum_grad != 1:
        raise ValueError("the SAM step takes feature input with accum_grad 1 (as the JAX SAM step)")
    loss_and_grads = make_loss_and_grads(net, config)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             lambda_m: Any = 1.0, margin_offset: Any = 0.0, lr_scale: Any = 1.0) -> Tuple[TrainState, dict]:
        net.train()
        x, y, mask = batch["x"], batch["y"], batch.get("mask")
        names = list(state.params)
        params = [state.params[k] for k in names]
        loss1, acc, new_stats, g1 = loss_and_grads(state.params, state.batch_stats, x, y, mask, generator,
                                                   lambda_m, margin_offset, 1.0)
        eps, gnorm = sam_ascent(params, g1, rho, adaptive)
        perturbed = dict(zip(names, torch._foreach_add(params, eps)))
        loss2, _, _, g2 = loss_and_grads(perturbed, dict(new_stats), x, y, mask, generator, lambda_m,
                                         margin_offset, 1.0)
        g2norm = global_norm(g2)
        finite = torch.isfinite(g2norm) & torch.isfinite(loss2)
        g2 = torch._foreach_mul(g2, torch.clamp_max(config.max_change / torch.clamp_min(g2norm, 1e-12), 1.0))
        updates, opt_state = tx.update(dict(zip(names, g2)), state.opt_state, state.params)
        new_params = dict(zip(names, torch._foreach_add(params, torch._foreach_mul([updates[k] for k in names],
                                                                                    lr_scale))))
        if config.skip_nonfinite:
            new_params = _keep(finite, new_params, state.params)
            opt_state = _keep(finite, opt_state, state.opt_state)
            new_stats = _keep(finite, new_stats, state.batch_stats)
        metrics = {"loss": loss1, "sam_loss": loss2, "accuracy": acc, "grad_norm": gnorm,
                   "skipped": 1.0 - finite.to(torch.float32)}
        return TrainState(step=state.step + 1, params=new_params, batch_stats=new_stats, opt_state=opt_state), metrics

    return step
