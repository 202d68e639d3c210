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

With a ``placement`` (parallel/mesh.py) it is the mesh step: both passes
run on this rank's rows inside the collectives' scope, on the parameters
gathered whole where ZeRO-3 shards them (the ascent's too, as JAX's
Launcher hands SAM its ``param_gather_fn``), the gradients are averaged
over ``"data"``, and the ascent's and the clip's norms, the losses and
the accuracy are the global ones.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from .optim import GradientTransformation
from .trainer import (TrainState, TrainStepConfig, _compute_type, _keep, _microbatch_scope, make_loss_and_grads)


def global_norm(tensors: List[torch.Tensor], placement=None, names=None) -> torch.Tensor:
    """The norm of every element of ``tensors``; with a placement, over
    every rank's shards (one all-reduce)."""
    if placement is None or placement.world == 1:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    return torch.sqrt(placement.world_sum(placement.sq_norm_parts(names, tensors)))


def sam_ascent(params: List[torch.Tensor], grads: List[torch.Tensor], rho: float,
               adaptive: bool, placement=None, names=None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(SAM's ascent e for each parameter, the norm it divides by): ``rho *
    g / max(|g|, 1e-12)``, or with ``adaptive`` ``rho * p^2 * g / max(|p *
    g|, 1e-12)`` (JAX train/sam.py:73-84)."""
    if adaptive:
        gnorm = global_norm(torch._foreach_mul(torch._foreach_abs(params), grads), placement, names)
        direction = torch._foreach_mul(torch._foreach_mul(params, params), grads)
    else:
        gnorm = global_norm(grads, placement, names)
        direction = grads
    return torch._foreach_mul(direction, rho / torch.clamp_min(gnorm, 1e-12)), gnorm


def make_sam_train_step(net: torch.nn.Module, tx: GradientTransformation, rho: float = 0.05,
                        adaptive: bool = False, config: TrainStepConfig = TrainStepConfig(),
                        placement=None) -> Callable:
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

        def pass_(weights, stats):
            """(loss, accuracy, stats, grads) on this rank's rows; on a
            mesh the weights gathered whole, the gradients averaged and
            cut back to the shards."""
            if placement is not None and placement.sharded:
                weights = placement.gather_params(weights, _compute_type(config, weights[placement.sharded[0]]))
            with _microbatch_scope(placement, x.shape[0]):
                out = loss_and_grads(weights, stats, x, y, mask, generator, lambda_m, margin_offset, 1.0)
            if placement is None:
                return out
            grads = placement.mean_grads(names, [g.to(state.params[k].dtype) for g, k in zip(out[3], names)])
            return (*out[:3], grads)

        loss1, acc, new_stats, g1 = pass_(state.params, state.batch_stats)
        eps, gnorm = sam_ascent(params, g1, rho, adaptive, placement, names)
        perturbed = dict(zip(names, torch._foreach_add(params, eps)))
        loss2, _, _, g2 = pass_(perturbed, dict(new_stats))
        g2norm = global_norm(g2, placement, names)
        if placement is not None:
            w = placement.world
            means = placement.world_sum(torch.stack([loss1 / w, acc.to(loss1.dtype) / w, loss2 / w]))
            loss1, acc, loss2 = means[0], means[1].float(), means[2]
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
