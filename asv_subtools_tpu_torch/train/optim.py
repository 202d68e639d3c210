"""Functional optimizers (counterpart: asv_subtools_tpu/train/optim.py).

An optimizer has optax's contract over a dict of parameter tensors (the
f32 master weights): ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``, with ``params + updates`` the new weights.
Nothing is written in place: the train step keeps the old state on a
non-finite step with ``torch.where`` on the device, with no host sync.
The state holds the optimizer's own step ``count``, which a schedule
reads, so it does not advance on a skipped step. The arithmetic is
optax's, over ``torch._foreach_*`` ops:

* adam(W): ``mu = b1*mu + (1-b1)*g``, ``nu = b2*nu + (1-b2)*g*g``,
  ``u = mu/(1-b1^t) / (sqrt(nu/(1-b2^t)) + eps)``, then
  ``u + wd*p`` for adamW, then ``-lr*u``;
* sgd: ``g + wd*p``, then the momentum trace ``t = g + momentum*t``
  (nesterov: ``g + momentum*t``), then ``-lr*u``;
* sgdW: the trace first, then ``+ wd*p``, then ``-lr*u``.

With ``decay_kernels_only`` the weight decay skips parameters of fewer
than two dims (biases and BN affines). These read the schedule at the
count before it advances, as optax's scale_by_schedule does.

The reference's own optimizers, each a transformation of JAX's
(optim.py:47-263), read the schedule at the advanced count (count + 1),
as JAX's do, and take no ``decay_kernels_only`` mask (JAX's factory hands
them none): :func:`adamod`, :func:`ralamb`, :func:`novograd` (a scalar
second moment per leaf) and :func:`eve`. Two wrappers go around any of
them: gradient centralisation (``gc``: the state is the pair ``({},
inner)``, optax.chain's tuple with gc's empty state first) and lookahead
(the state ``{"inner", "slow", "count"}``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], Tuple[Params, dict]]
    # True when each element's update reads only that element (and
    # scalars): such an optimizer updates a flat ZeRO-3 shard as it would
    # the whole leaf
    elementwise: bool = False


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

    return GradientTransformation(init, update, elementwise=not weight_decay or mask is None)


def sgd(learning_rate: LearningRate, momentum: Optional[float] = None, nesterov: bool = False
        ) -> GradientTransformation:
    """optax.sgd: plain -lr*g without momentum."""
    return _optimizer(learning_rate, momentum=momentum, nesterov=nesterov)


def _lr(learning_rate: LearningRate, count: torch.Tensor, dtype: torch.dtype):
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    return lr.to(dtype) if isinstance(lr, torch.Tensor) else lr


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _count(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)


def _moments(grads: Params, state: dict, b1: float, b2: float) -> Tuple[Params, Params]:
    """optax's tree_update_moment (order 1) and ..._per_elem_norm (order 2)."""
    mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in grads.items()}
    return mu, nu


def adamod(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999, b3: float = 0.999, eps: float = 1e-8,
           weight_decay: float = 0.0) -> GradientTransformation:
    """AdaMod (JAX optim.py:47-96): the per-element rate ``lr * sqrt(1-b2^t)
    / (1-b1^t) / (sqrt(nu) + eps)`` is bounded by its long-term mean
    ``eta`` (decay ``b3``) and multiplies the raw first moment; weight
    decay ``wd * lr * p``. State: count, mu, nu, eta."""

    def init(params: Params) -> dict:
        return {"count": _count(params), "mu": _zeros(params), "nu": _zeros(params), "eta": _zeros(params)}

    def update(grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        count = state["count"] + 1
        dtype = next(iter(grads.values())).dtype
        lr = _lr(learning_rate, count, dtype)
        mu, nu = _moments(grads, state, b1, b2)
        t = count.to(dtype)
        scale = lr * torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        out, eta = {}, {}
        for k, p in params.items():
            rate = scale / (torch.sqrt(nu[k]) + eps)
            eta[k] = b3 * state["eta"][k] + (1 - b3) * rate
            out[k] = -torch.minimum(rate, eta[k]) * mu[k]
            if weight_decay:
                out[k] = out[k] - weight_decay * lr * p
        return out, {"count": count, "mu": mu, "nu": nu, "eta": eta}

    return GradientTransformation(init, update, elementwise=True)


def ralamb(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           weight_decay: float = 0.0, n_sma_threshold: float = 4.0) -> GradientTransformation:
    """Ralamb (JAX optim.py:98-160): RAdam's rectifier (the step ``lr * rect /
    (1-b1^t)`` and ``mu / (sqrt(nu) + eps)`` once n_sma passes the
    threshold, ``lr / (1-b1^t)`` and ``mu`` before) times the trust ratio
    ``min(|p|, 10) / |p - wd*lr*p|`` (1 where either norm is 0), on the
    decayed weights. The rectified branch is chosen on the device."""

    def init(params: Params) -> dict:
        return {"count": _count(params), "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        count = state["count"] + 1
        dtype = next(iter(grads.values())).dtype
        lr = _lr(learning_rate, count, dtype)
        mu, nu = _moments(grads, state, b1, b2)
        t = count.to(dtype)
        beta2_t = b2 ** t
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
        rect = torch.sqrt(torch.abs((1.0 - beta2_t) * (n_sma - 4.0) / (n_sma_max - 4.0) * (n_sma - 2.0) / n_sma
                                    * n_sma_max / (n_sma_max - 2.0)))
        rectified = n_sma > n_sma_threshold
        bc1 = 1.0 - b1 ** t
        radam_step = torch.where(rectified, lr * rect / bc1, lr / bc1)
        out = {}
        for k, p in params.items():
            p_dec = p - weight_decay * lr * p if weight_decay else p
            weight_norm = torch.clamp(torch.linalg.vector_norm(p), 0.0, 10.0)
            radam_norm = torch.linalg.vector_norm(p_dec)
            trust = torch.where((weight_norm == 0.0) | (radam_norm == 0.0), 1.0, weight_norm / radam_norm)
            delta = torch.where(rectified, mu[k] / (torch.sqrt(nu[k]) + eps), mu[k])
            out[k] = (p_dec - radam_step * trust * delta) - p
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def novograd(learning_rate: LearningRate, b1: float = 0.95, b2: float = 0.25, eps: float = 1e-8,
             weight_decay: float = 0.0, grad_averaging: bool = False) -> GradientTransformation:
    """Novograd (JAX optim.py:163-211): a scalar second moment ``nu`` per
    leaf, seeded with the first squared gradient norm (where it is still
    0, chosen on the device), ``mu = b1*mu + g / (sqrt(nu) + eps)`` (times
    1 - b1 with ``grad_averaging``), update ``-lr*mu - wd*lr*p``."""

    def init(params: Params) -> dict:
        return {"count": _count(params), "mu": _zeros(params),
                "nu": {k: torch.zeros((), dtype=p.dtype, device=p.device) for k, p in params.items()}}

    def update(grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        count = state["count"] + 1
        lr = _lr(learning_rate, count, next(iter(grads.values())).dtype)
        out, mu, nu = {}, {}, {}
        for k, g in grads.items():
            norm = torch.sum(g * g)
            v = state["nu"][k]
            nu[k] = torch.where(v == 0.0, norm, b2 * v + (1 - b2) * norm)
            gn = g / (torch.sqrt(nu[k]) + eps)
            if grad_averaging:
                gn = gn * (1 - b1)
            mu[k] = b1 * state["mu"][k] + gn
            out[k] = -lr * mu[k]
            if weight_decay:
                out[k] = out[k] - weight_decay * lr * params[k]
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def eve(learning_rate: LearningRate = 1e-3, b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
        weight_decay: float = 1e-3, target_rms: float = 0.1) -> GradientTransformation:
    """Eve, the k2/icefall variant (JAX optim.py:214-263): AdamW whose weight
    decay ``p * (1 - wd)`` (not lr-scaled) applies only while a leaf's RMS
    is above ``target_rms``; a leaf of one element is not decayed and is
    clamped to [-10, 2] after the step (the ReConformer's BasicNorm
    ``eps``)."""

    def init(params: Params) -> dict:
        return {"count": _count(params), "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        count = state["count"] + 1
        dtype = next(iter(grads.values())).dtype
        lr = _lr(learning_rate, count, dtype)
        mu, nu = _moments(grads, state, b1, b2)
        t = count.to(dtype)
        step_size = lr / (1.0 - b1 ** t)
        bc2 = 1.0 - b2 ** t
        out = {}
        for k, p in params.items():
            denom = torch.sqrt(nu[k]) * bc2 ** -0.5 + eps
            if p.numel() > 1:
                above = torch.linalg.vector_norm(p) > target_rms * p.numel() ** 0.5
                p_new = p * (1.0 - weight_decay * above.to(p.dtype)) - step_size * mu[k] / denom
            else:
                p_new = torch.clamp(p - step_size * mu[k] / denom, -10.0, 2.0)
            out[k] = p_new - p
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def gradient_centralization() -> GradientTransformation:
    """Subtract from each gradient of two dims or more its mean over every
    dim but the leaf's output axis (JAX optim.py:23-45, where flax's layout
    puts that axis last). The axis comes from the leaf's name and shape by
    weights.py's rules (``output_axis``): dim 0 for the port's conv and
    Linear weights, the last dim for the leaves that keep JAX's layout
    (``_SplitGlobalConv``'s kernel, the attention's ``pos_bias_u/v``, the
    margin heads' classifier). Stateless: its state is ``{}``."""

    def update(grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        from ..weights import output_axis

        out = {}
        for k, g in grads.items():
            if g.dim() >= 2:
                axis = output_axis(k, g) % g.dim()
                g = g - g.mean(dim=tuple(d for d in range(g.dim()) if d != axis), keepdim=True)
            out[k] = g
        return out, state

    return GradientTransformation(lambda params: {}, update)


def lookahead_wrapper(inner: GradientTransformation, k: int = 5, alpha: float = 0.5) -> GradientTransformation:
    """Lookahead as JAX's update rewrite (optim.py:355-387): ``inner``'s
    update, and on every k-th count the weights land on ``slow + alpha *
    (fast - slow)``, which becomes the new slow copy. The sync is chosen
    on the device. State: {"inner", "slow", "count"}."""

    def init(params: Params) -> dict:
        return {"inner": inner.init(params), "slow": {n: p.clone() for n, p in params.items()},
                "count": _count(params)}

    def update(grads: Params, state: dict, params: Params) -> Tuple[Params, dict]:
        updates, inner_state = inner.update(grads, state["inner"], params)
        count = state["count"] + 1
        sync = (count % k) == 0
        out, slow = {}, {}
        for n, p in params.items():
            s = state["slow"][n]
            slow_new = s + alpha * ((p + updates[n]) - s)
            out[n] = torch.where(sync, slow_new - p, updates[n])
            slow[n] = torch.where(sync, slow_new, s)
        return out, {"inner": inner_state, "slow": slow, "count": count}

    return GradientTransformation(init, update, elementwise=inner.elementwise)


def _chain(first: GradientTransformation, second: GradientTransformation) -> GradientTransformation:
    """optax.chain of two: the state is the pair of their states."""

    def update(grads: Params, state: tuple, params: Params) -> Tuple[Params, tuple]:
        u, s1 = first.update(grads, state[0], params)
        u, s2 = second.update(u, state[1], params)
        return u, (s1, s2)

    return GradientTransformation(lambda params: (first.init(params), second.init(params)), update,
                                  elementwise=first.elementwise and second.elementwise)


def get_optimizer(name: str = "adamW", learning_rate: LearningRate = 3e-4, beta1: float = 0.9,
                  beta2: float = 0.999, beta3: float = 0.999, weight_decay: float = 1e-4, momentum: float = 0.9,
                  nesterov: bool = False, gc: bool = False, lookahead: bool = False, lookahead_k: int = 5,
                  lookahead_alpha: float = 0.5, sam: bool = False, sam_rho: float = 0.05,
                  sam_adaptive: bool = False, eps: float = 1e-8, decay_kernels_only: bool = False
                  ) -> GradientTransformation:
    """An optimizer by the reference's name: sgd | sgdw | adam | adamW |
    ralamb | adamod | novograd | eve, with the JAX factory's signature.
    ``adam`` takes no weight decay, as the JAX factory's optax.adam does;
    ralamb, adamod, novograd and eve take no ``decay_kernels_only`` mask,
    as JAX's take none. ``gc`` centralises the gradients first,
    ``lookahead`` wraps the whole (``lookahead_k``, ``lookahead_alpha``).
    ``sam`` raises ValueError: SAM is a train step here (train/sam.py
    ``make_sam_train_step``), which the Launcher takes for ``train.sam`` or
    the optimizer's ``sam`` flag. JAX's factory wraps the base in
    optax.contrib.sam, whose update needs a gradient function that no
    train step hands it (and under optax 0.2.6 the call raises TypeError:
    no ``rho`` keyword); ``sam_rho`` and ``sam_adaptive`` belong to the
    flag."""
    key = name.lower()
    if sam:
        raise ValueError("SAM is a train step, not an optimizer: use train/sam.py make_sam_train_step (the "
                         "Launcher takes it for train.sam or the optimizer's sam flag)")
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
    elif key == "ralamb":
        base = ralamb(learning_rate, b1=beta1, b2=beta2, eps=eps, weight_decay=weight_decay)
    elif key == "adamod":
        base = adamod(learning_rate, b1=beta1, b2=beta2, b3=beta3, eps=eps, weight_decay=weight_decay)
    elif key == "novograd":
        base = novograd(learning_rate, b1=beta1, b2=beta2, eps=eps, weight_decay=weight_decay)
    elif key == "eve":
        base = eve(learning_rate, b1=beta1, b2=beta2, eps=eps, weight_decay=weight_decay)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    if gc:
        base = _chain(gradient_centralization(), base)
    if lookahead:
        base = lookahead_wrapper(base, lookahead_k, lookahead_alpha)
    return base
