"""Functional optimizers (counterpart: asv_subtools_tpu/train/optim.py:266-346).

An optimizer has optax's contract over a dict of parameter tensors (the
f32 master weights): ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``, with ``params + updates`` the new weights.
Nothing is written in place: the train step keeps the old state on a
non-finite step with ``torch.where`` on the device, with no host sync.
The state holds the optimizer's own step ``count``, which a schedule
reads (before it advances, as optax's scale_by_schedule does), so it does
not advance on a skipped step. The arithmetic is optax's, over
``torch._foreach_*`` ops:

* adam(W): ``mu = b1*mu + (1-b1)*g``, ``nu = b2*nu + (1-b2)*g*g``,
  ``u = mu/(1-b1^t) / (sqrt(nu/(1-b2^t)) + eps)``, then
  ``u + wd*p`` for adamW, then ``-lr*u``;
* sgd: ``g + wd*p``, then the momentum trace ``t = g + momentum*t``
  (nesterov: ``g + momentum*t``), then ``-lr*u``;
* sgdW: the trace first, then ``+ wd*p``, then ``-lr*u``.

With ``decay_kernels_only`` the weight decay skips parameters of fewer
than two dims (biases and BN affines).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], Tuple[Params, dict]]


def no_weight_decay_mask(params: Params) -> Dict[str, bool]:
    """Decay only kernels of two dims or more; biases and norm scales are exempt."""
    return {k: p.dim() >= 2 for k, p in params.items()}


def _optimizer(learning_rate: LearningRate, *, adam: Optional[Tuple[float, float, float]] = None,
               momentum: Optional[float] = None, nesterov: bool = False, weight_decay: float = 0.0,
               decay_first: bool = False, mask: Optional[Callable[[Params], Dict[str, bool]]] = None
               ) -> GradientTransformation:
    """decay (if decay_first) -> adam moments or momentum trace -> decay
    (otherwise) -> times -lr."""

    def init(params: Params) -> dict:
        first = next(iter(params.values()))
        state = {"count": torch.zeros((), dtype=torch.int32, device=first.device)}
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        if adam is not None:
            state.update(mu=zeros(), nu=zeros())
        elif momentum is not None:
            state["trace"] = zeros()
        return state

    def decay(u, names, params):
        if not weight_decay:
            return u
        keep = mask(params) if mask is not None else {k: True for k in names}
        return [ui + weight_decay * params[k] if keep[k] else ui for ui, k in zip(u, names)]

    def update(grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        names = list(grads)
        u = [grads[k] for k in names]
        new = {"count": state["count"] + 1}
        if decay_first:
            u = decay(u, names, params)
        if adam is not None:
            b1, b2, eps = adam
            mu = torch._foreach_add(torch._foreach_mul([state["mu"][k] for k in names], b1), u, alpha=1 - b1)
            nu = torch._foreach_addcmul(torch._foreach_mul([state["nu"][k] for k in names], b2), u, u,
                                        value=1 - b2)
            t = new["count"].to(u[0].dtype)
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** t)), eps)
            u = torch._foreach_div(torch._foreach_div(mu, 1 - b1 ** t), denom)
            new.update(mu=dict(zip(names, mu)), nu=dict(zip(names, nu)))
        elif momentum is not None:
            trace = torch._foreach_add(u, torch._foreach_mul([state["trace"][k] for k in names], momentum))
            u = torch._foreach_add(u, torch._foreach_mul(trace, momentum)) if nesterov else trace
            new["trace"] = dict(zip(names, trace))
        if not decay_first:
            u = decay(u, names, params)
        lr = learning_rate(state["count"]) if callable(learning_rate) else learning_rate
        if isinstance(lr, torch.Tensor):
            lr = lr.to(u[0].dtype)
        u = torch._foreach_mul(u, -lr)
        return dict(zip(names, u)), new

    return GradientTransformation(init, update)


def sgd(learning_rate: LearningRate, momentum: Optional[float] = None, nesterov: bool = False
        ) -> GradientTransformation:
    """optax.sgd: plain -lr*g without momentum."""
    return _optimizer(learning_rate, momentum=momentum, nesterov=nesterov)


_NOT_PORTED = ("ralamb", "adamod", "novograd", "eve")


def get_optimizer(name: str = "adamW", learning_rate: LearningRate = 3e-4, beta1: float = 0.9,
                  beta2: float = 0.999, beta3: float = 0.999, weight_decay: float = 1e-4, momentum: float = 0.9,
                  nesterov: bool = False, gc: bool = False, lookahead: bool = False, lookahead_k: int = 5,
                  lookahead_alpha: float = 0.5, sam: bool = False, sam_rho: float = 0.05,
                  sam_adaptive: bool = False, eps: float = 1e-8, decay_kernels_only: bool = False
                  ) -> GradientTransformation:
    """An optimizer by the reference's name: sgd | sgdw | adam | adamW, with
    the JAX factory's signature. ``adam`` takes no weight decay, as the
    JAX factory's optax.adam does. ``sam`` raises ValueError: SAM is a
    train step here (train/sam.py ``make_sam_train_step``), which the
    Launcher takes for ``train.sam`` or the optimizer's ``sam`` flag.
    JAX's factory wraps the base in optax.contrib.sam, whose update needs
    a gradient function that no train step hands it (and under optax 0.2.6
    the call raises TypeError: no ``rho`` keyword); ``sam_rho`` and
    ``sam_adaptive`` belong to the flag.

    ralamb, adamod, novograd, eve and the lookahead and gc wrappers are
    not ported yet and raise NotImplementedError naming ROADMAP Queue 1
    item 8; beta3 and the lookahead settings belong to them."""
    key = name.lower()
    if sam:
        raise ValueError("SAM is a train step, not an optimizer: use train/sam.py make_sam_train_step (the "
                         "Launcher takes it for train.sam or the optimizer's sam flag)")
    if key in _NOT_PORTED or gc or lookahead:
        raise NotImplementedError(f"optimizer {name!r} (gc={gc}, lookahead={lookahead}) is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    mask = no_weight_decay_mask if decay_kernels_only else None
    if key == "sgd":
        base = _optimizer(learning_rate, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay,
                          decay_first=True, mask=mask)
    elif key == "sgdw":
        base = _optimizer(learning_rate, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay, mask=mask)
    elif key == "adam":
        base = _optimizer(learning_rate, adam=(beta1, beta2, eps))
    elif key in ("adamw", "adam_w"):
        base = _optimizer(learning_rate, adam=(beta1, beta2, eps), weight_decay=weight_decay, mask=mask)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    return base
