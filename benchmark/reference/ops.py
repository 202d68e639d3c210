"""The reference's products and normalisations, in plain PyTorch.

Every product of the reference networks goes through :func:`conv1d`,
:func:`conv2d` or :func:`matmul`, and every tensor that the program
holds in its compute type between operations through :func:`held`. They
take a quantiser ``q``: None computes in float32, and :data:`fp8_round`
is the lower-precision control of a bfloat16 program, float8 e4m3 where
the program holds bfloat16 (weights, operands, products, activations,
their gradients on the way back), float32 where it keeps float32. The
batch norm here serves both modes: eval (running statistics) and train
(batch statistics over every axis but the channels, padded frames left
out under a mask).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional["Float8"]
Params = Dict[str, torch.Tensor]
BN_EPS = 1e-5
# a dict under this key of the parameters collects each train-mode BN's
# batch statistics by its name
BATCH_STATS = "__batch_stats__"


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude to 448, the format's largest), back in x's type."""
    scale = 448.0 / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Round(torch.autograd.Function):
    """Rounds the value on the way forward and its gradient on the way back."""

    @staticmethod
    def forward(ctx, y):
        return _e4m3(y)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


class Float8:
    """Computing in float8 e4m3 where the program computes in bfloat16:
    ``q(x)`` rounds a tensor that the program holds in bfloat16 (a weight
    cast for the forward, a product's operand, an activation) and, on
    the way back, its gradient. What the program keeps in float32 (BN
    statistics, the margin head's cosines and softmax) stays float32."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x) if x.requires_grad else _e4m3(x)


fp8_round = Float8()


def held(x: torch.Tensor, q: Quant) -> torch.Tensor:
    """x as the program holds it between operations: in its compute type,
    which the control lowers to float8."""
    return x if q is None else q(x)


def conv1d(x, w, b=None, q: Quant = None, **kw):
    if q is None:
        return F.conv1d(x, w, b, **kw)
    return q(F.conv1d(q(x), q(w), None if b is None else q(b), **kw))


def conv2d(x, w, b=None, q: Quant = None, **kw):
    if q is None:
        return F.conv2d(x, w, b, **kw)
    return q(F.conv2d(q(x), q(w), None if b is None else q(b), **kw))


def matmul(a, b, q: Quant = None):
    if q is None:
        return a @ b
    return q(q(a) @ q(b))


def linear(P: Params, pre: str, x, q: Quant = None):
    """x [..., in] @ W.T + b of a torch Linear named ``pre``."""
    return held(matmul(x, P[pre + ".weight"].t(), q) + held(P[pre + ".bias"], q), q)


def batch_norm(P: Params, pre: str, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               train: bool = False, q: Quant = None) -> torch.Tensor:
    """BatchNorm ``pre`` over axis 1 of x [B, C, ...]. Eval: the running
    ``mean`` and ``var``. Train: the batch's mean and biased variance over
    every other axis; a [B, T] mask of a [B, C, T] input leaves padded
    frames out."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        dims = (0,) + tuple(range(2, x.dim()))
        if mask is None:
            n = x.numel() // x.shape[1]
            bessel = n / max(n - 1, 1)
            mean = x.mean(dims)
            var = ((x - mean.view(shape)) ** 2).mean(dims)
        else:
            m = mask.to(x.dtype)[:, None, :]
            count = torch.clamp_min(m.sum(), 1.0)
            bessel = count / torch.clamp_min(count - 1.0, 1.0)
            mean = (x * m).sum(dims) / count
            var = (((x - mean.view(shape)) ** 2) * m).sum(dims) / count
        seen = P.get(BATCH_STATS)
        if seen is not None:  # the statistics a running average would take: mean, unbiased variance
            seen[pre] = (mean.detach(), (var * bessel).detach())
    else:
        mean, var = P[pre + ".mean"], P[pre + ".var"]
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
    scale, bias = held(P[pre + ".scale"], q), held(P[pre + ".bias"], q)
    return held(y * scale.view(shape) + bias.view(shape), q)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of x [B, C, T] over its valid frames -> [B, C]."""
    if mask is None:
        return x.mean(-1)
    m = mask.to(x.dtype)[:, None, :]
    return (x * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)
