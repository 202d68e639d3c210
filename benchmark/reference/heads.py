"""Loss heads and the optimiser step, in plain PyTorch.

:func:`margin_loss` is ASV-Subtools' ``margin_softmax`` head: cosines of
the normalised embedding against the normalised class weights, the
target's cosine penalised by the margin ``m`` (``am``: cos - m, the
additive margin; ``aam``: cos(theta + m), the additive angular margin),
everything scaled by ``s``, cross entropy averaged over the batch.
:func:`clip_and_sgd` clips the gradients by their global norm
(``max_change``; the denominator norm + 1e-6 is torch's
``clip_grad_norm_``'s) and applies one step of torch's SGD: the weight
decay added to the gradient first, the momentum trace, the learning
rate of the warm-restart cosine schedule (:func:`warm_restarts_lr`) at
the steps taken so far.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .ops import Quant, held


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def margin_loss(weight: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor, head: dict,
                q: Quant = None) -> torch.Tensor:
    """weight [classes, E], emb [B, E], targets [B] -> mean loss; ``head``:
    name (``am`` or ``aam``), m, s."""
    # the cosines and the softmax in float32, of the embedding and the
    # weights as the program holds them
    cos = _unit(held(emb, q)) @ _unit(held(weight, q)).t()
    idx = targets.long()[:, None]
    cos_t = cos.gather(1, idx)
    if head["name"] == "am":
        pen = cos_t - head["m"]
    elif head["name"] == "aam":
        pen = torch.cos(torch.arccos(torch.clamp(cos_t, -1.0, 1.0)) + head["m"])
    else:
        raise ValueError(f"unknown margin head {head['name']!r}")
    logits = head["s"] * cos.scatter(1, idx, pen)
    return -torch.log_softmax(logits, dim=-1).gather(1, idx).mean()


def warm_restarts_lr(schedule: dict, step: int) -> float:
    """SGDR's cosine with warm restarts of period ``t_0`` from ``base_lr``
    down to ``eta_min``, at ``step`` steps taken."""
    base, t_0, low = schedule["base_lr"], schedule["t_0"], schedule["eta_min"]
    return low + (base - low) * 0.5 * (1.0 + math.cos(math.pi * (step % t_0) / t_0))


def clip_and_sgd(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict, opt: dict,
                 schedule: dict) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], dict]:
    """-> (new params, the clipped gradients the optimiser took, new
    state). ``state`` holds ``t`` (steps taken) and the momentum
    ``trace``; empty at the first step. ``opt``: momentum, weight_decay,
    max_change; ``schedule``: the warm-restart schedule's numbers."""
    names: List[str] = list(params)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(grads[k]) for k in names]))
    factor = torch.clamp_max(opt["max_change"] / (norm + 1e-6), 1.0)
    clipped = {k: grads[k] * factor for k in names}
    t = state.get("t", 0)
    lr = warm_restarts_lr(schedule, t)
    trace = {}
    for k in names:
        u = clipped[k] + opt["weight_decay"] * params[k]
        trace[k] = u + opt["momentum"] * state["trace"][k] if state else u
    new = {k: params[k] - lr * trace[k] for k in names}
    return new, clipped, {"t": t + 1, "trace": trace}
