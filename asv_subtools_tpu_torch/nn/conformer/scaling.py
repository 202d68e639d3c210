"""The ReConformer's stabilisers (counterpart:
asv_subtools_tpu/nn/conformer/scaling.py).

``activation_balancer`` is the identity in the forward; its backward
nudges each channel's gradient so that the channel's values are positive
within [min_positive, max_positive] of the time and its mean |x| within
[min_abs, max_abs]. JAX writes it as a ``jax.custom_vjp``; here it is a
``torch.autograd.Function`` whose forward takes the per-channel
statistics in x's type (as JAX's forward rule does) and whose backward
applies them. Where no gradient is asked for (serving), it returns x and
computes nothing. ``BasicNorm`` is the LayerNorm replacement
``x * (mean(x^2) + exp(log_eps))^-0.5`` over the last axis, with a
learnable 0-dim ``eps`` (the log of epsilon) or a fixed one.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class _Balancer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, channel_dim, min_positive, max_positive, max_factor, min_abs, max_abs):
        dim = channel_dim % x.dim()
        sum_dims = tuple(d for d in range(x.dim()) if d != dim)
        xgt0 = x > 0
        proportion_positive = xgt0.to(x.dtype).mean(sum_dims, keepdim=True)
        factor = torch.zeros_like(proportion_positive)
        if min_positive != 0.0:
            factor = factor + torch.relu(min_positive - proportion_positive) * (max_factor / min_positive)
        if max_positive != 1.0:
            factor = factor + torch.relu(proportion_positive - max_positive) * (max_factor / (max_positive - 1.0))
        mean_abs = x.abs().mean(sum_dims, keepdim=True)
        ctx.save_for_backward(factor, xgt0, mean_abs < min_abs, mean_abs > max_abs)
        ctx.max_factor = max_factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        factor, xgt0, below, above = ctx.saved_tensors
        dtype = g.dtype
        scale_factor = (below.to(dtype) - above.to(dtype)) * (xgt0.to(dtype) - 0.5) * (ctx.max_factor * 2.0)
        return g - g.abs() * (factor.to(dtype) + scale_factor), None, None, None, None, None, None


def activation_balancer(x: torch.Tensor, channel_dim: int = -1, min_positive: float = 0.05,
                        max_positive: float = 0.95, max_factor: float = 0.01, min_abs: float = 0.2,
                        max_abs: float = 100.0) -> torch.Tensor:
    """x unchanged; in the backward ``g - |g| * (factor + scale_factor)`` per
    channel (``channel_dim``), from the forward's statistics
    (ActivationBalancerFunction)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Balancer.apply(x, channel_dim, min_positive, max_positive, max_factor, min_abs, max_abs)


class BasicNorm(nn.Module):
    """x * (mean(x^2 over the last axis) + exp(log_eps))^-0.5. With
    ``learn_eps`` the log-epsilon is the 0-dim parameter ``eps`` (log(0.25)
    at init, in float32 as flax makes it); without, it is log(eps) in x's
    type, as in JAX."""

    def __init__(self, eps: float = 0.25, learn_eps: bool = True):
        super().__init__()
        self.eps_value, self.learn_eps = eps, learn_eps
        if learn_eps:
            self.eps = nn.Parameter(torch.tensor(math.log(eps), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.learn_eps:
            eps = torch.exp(self.eps).to(x.dtype)
        else:
            # a host value: log and exp in x's type on the CPU, no copy to the card
            eps = float(torch.tensor(self.eps_value, dtype=x.dtype).log().exp())
        return x * (torch.mean(x * x, dim=-1, keepdim=True) + eps) ** -0.5
