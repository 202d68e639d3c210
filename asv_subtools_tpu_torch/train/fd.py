"""Feature-decomposition adversarial training, two optimizers in turn
(counterpart: asv_subtools_tpu/train/fd.py; parity:
pytorch/libs/training/trainer_fd.py GanDalAttTrainer, train_one_batch
:427-500, and snowdar-xvector-FD-AL.py get_loss :295-308).

    loss = spk_loss(spk_emb) + aux_weight * aux_loss(content_emb, aux_y)
           + adv_weight * DAL(content_emb, spk_emb)

A step with ``step_index % cycle < adv_steps`` is an adversary step: the
DAL projections (the ``dal`` leaves) alone move, by the adversary's
optimizer on the FLIPPED gradients, unclipped; every other step is a main
step: every leaf but ``dal`` moves by the main optimizer on gradients
clipped over that partition as ``min(1, max_change / max(|g|, 1e-12))``.
Each optimizer sees zeros for the leaves outside its partition and its
updates there are dropped (weight decay would otherwise move them), as
JAX's masks do. The state's ``opt_state`` is the pair (main, adversary).
JAX picks the phase with ``lax.cond`` on the device step counter; here
the caller hands the step index in from the host (the Trainer keeps the
count there), so a step never waits on the card and runs one optimizer.

With a ``placement`` (parallel/mesh.py, every leaf replicated: JAX's FD
step runs data-parallel and replicated, launcher.py:523-590) the step
runs on this rank's rows with global BatchNorm statistics, averages the
gradients over ``"data"`` and reports the global batch's loss, accuracy
and DAL cosine.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..models.multitask import DALRegularizer, FDXvector
from ..nn.loss import LOSSES
from ..nn.loss import accuracy as compute_accuracy
from .optim import GradientTransformation
from .trainer import TrainState, TrainStepConfig, _keep, _microbatch_scope


class FDSpeakerNet(nn.Module):
    """FDXvector + the speaker head ``loss`` + the auxiliary (e.g. noise
    type) head ``loss2`` + the regularizer ``dal``. ``forward(x, targets,
    aux_targets, mask) -> (spk_loss, aux_loss, adv, logits)``."""

    def __init__(self, backbone: FDXvector, num_targets: int, num_aux_targets: int = 9,
                 loss_name: str = "margin_softmax", loss_params: Optional[dict] = None,
                 aux_loss_name: str = "softmax", aux_loss_params: Optional[dict] = None):
        super().__init__()
        self.backbone = backbone
        self.num_aux_targets = num_aux_targets
        d = backbone.embd_dim
        self.loss = LOSSES[loss_name](d, num_targets, **(loss_params or {}))
        self.loss2 = LOSSES[aux_loss_name](d, num_aux_targets, **(aux_loss_params or {}))
        self.dal = DALRegularizer(d)
        self.to(next(backbone.parameters()).device)
        self.train(backbone.training)

    def forward(self, x: torch.Tensor, targets: torch.Tensor, aux_targets: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        spk_emb, content_emb = self.backbone(x, mask)
        spk_loss, logits = self.loss(spk_emb, targets)
        aux_loss, _ = self.loss2(content_emb, aux_targets)
        return spk_loss, aux_loss, self.dal(content_emb, spk_emb), logits


def is_adversary(name: str) -> bool:
    """The adversary partition: the DAL projections only (trainer_fd.py:393-415
    set_train_mode; the att gate trains in the main phase)."""
    return "dal" in name.split(".")


def init_fd_state(net: FDSpeakerNet, tx_main: GradientTransformation, tx_adv: GradientTransformation,
                  device: Any = None) -> TrainState:
    """Step 0 from the net's weights on ``device`` (the CUDA card unless
    ``device="cpu"``; raises without a card), with both optimizers' states."""
    dev = resolve_device(device)
    net.to(dev)
    params = {k: p.detach().clone() for k, p in net.named_parameters()}
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
                      batch_stats={k: b.detach().clone() for k, b in net.named_buffers()},
                      opt_state=(tx_main.init(params), tx_adv.init(params)))


def make_fd_train_step(net: FDSpeakerNet, tx_main: GradientTransformation, tx_adv: GradientTransformation,
                       aux_weight: float = 0.1, adv_weight: float = 0.1, cycle: int = 70, adv_steps: int = 20,
                       config: TrainStepConfig = TrainStepConfig(), placement=None):
    """Build ``step(state, batch, generator=None, lambda_m=1.0,
    margin_offset=0.0, lr_scale=1.0, *, step_index) -> (state, metrics)``,
    the train step's signature, so that the Trainer runs it.

    batch = {"x": [B, T, D], "y": [B], optional "aux_y" [B] (default
    ``y % num_aux_targets``), optional "mask" [B, T]}; ``step_index`` is
    the state's step as a Python int. ``lr_scale`` (ReduceOnPlateau's)
    scales the main optimizer's updates; the generator and the margin
    inputs go unused (the FD net has no dropout, and its heads no margin
    warm-up, as in JAX). metrics (0-dim device tensors but
    ``phase_adv``): loss, accuracy, adversarial_cos, phase_adv (1.0 in an
    adversary step) and skipped; a step with a non-finite loss keeps the
    weights and BN statistics (the optimizer states advance, as in JAX)."""
    if config.wave_input or config.accum_grad != 1:
        raise ValueError("the FD step takes feature input with accum_grad 1 (as the JAX FD step)")
    if placement is not None and any(placement.specs.values()):
        raise ValueError("the FD step runs replicated: build its placement without partition rules")
    dtype = config.compute_dtype

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: Any = None, lambda_m: Any = 1.0,
             margin_offset: Any = 0.0, lr_scale: Any = 1.0, *, step_index: int) -> Tuple[TrainState, dict]:
        net.train()
        x, y, mask = batch["x"], batch["y"], batch.get("mask")
        aux_y = batch["aux_y"] if "aux_y" in batch else y % net.num_aux_targets
        names = list(state.params)
        leaves = {k: p.detach().requires_grad_() for k, p in state.params.items()}
        tensors = {k: p.to(dtype) if p.dtype == torch.float32 else p for k, p in leaves.items()}
        tensors.update(state.batch_stats)
        with _microbatch_scope(placement, x.shape[0]):
            spk_loss, aux_loss, adv, logits = torch.func.functional_call(net, tensors, (x.to(dtype), y, aux_y),
                                                                         {"mask": mask})
            loss = (spk_loss + aux_weight * aux_loss + adv_weight * adv).float()
            grads = list(torch.autograd.grad(loss, list(leaves.values())))
        acc = compute_accuracy(logits.detach(), y)
        loss, adv = loss.detach(), adv.detach()
        if placement is not None:
            grads = placement.mean_grads(names, grads)
            w = placement.world
            means = placement.world_sum(torch.stack([loss / w, acc / w, adv.to(loss.dtype) / w]))
            loss, acc, adv = means[0], means[1], means[2].to(adv.dtype)
        grads = dict(zip(names, grads))
        new_stats = {k: tensors[k] for k in state.batch_stats}
        main_state, adv_state = state.opt_state

        in_adv = step_index % cycle < adv_steps
        mine = {k: is_adversary(k) == in_adv for k in names}
        if in_adv:
            # maximisation: the flipped gradients, no clip (the reference
            # clips on the main optimizer's path only, trainer_fd.py:468-496)
            g = {k: -grads[k] if mine[k] else torch.zeros_like(grads[k]) for k in names}
            updates, adv_state = tx_adv.update(g, adv_state, state.params)
        else:
            g = {k: grads[k] if mine[k] else torch.zeros_like(grads[k]) for k in names}
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(g.values()))))
            scale = torch.clamp_max(config.max_change / torch.clamp_min(gnorm, 1e-12), 1.0)
            g = dict(zip(names, torch._foreach_mul(list(g.values()), scale)))
            updates, main_state = tx_main.update(g, main_state, state.params)
            updates = dict(zip(updates, torch._foreach_mul(list(updates.values()), lr_scale)))
        new_params = {k: state.params[k] + updates[k] if mine[k] else state.params[k] for k in names}

        finite = torch.isfinite(loss)
        metrics = {"loss": loss, "accuracy": acc, "adversarial_cos": adv,
                   "phase_adv": float(in_adv), "skipped": 1.0 - finite.to(torch.float32)}
        return TrainState(step=state.step + 1, params=_keep(finite, new_params, state.params),
                          batch_stats=_keep(finite, new_stats, state.batch_stats),
                          opt_state=(main_state, adv_state)), metrics

    return step
