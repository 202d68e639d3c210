"""Masked BatchNorm and LayerNorm (counterpart: asv_subtools_tpu/nn/norm.py:26-92).

BatchNorm's features sit on dim 1 (``[B, C]`` or ``[B, C, T]``), the
layout the port's model holds; a ``[B, T]`` mask (True = valid) keeps padded frames
out of the batch statistics, which is why ``torch.nn.BatchNorm1d`` cannot
stand in for it. Parameters and buffers keep the flax names (``scale``,
``bias``, ``mean``, ``var``) so weights map one to one. ``use_scale`` and
``use_bias`` off (the snowdar x-vectors' non-affine BN) leave the module
without that parameter at all, as flax's does.

Train mode (``module.training``) normalises with the masked batch
statistics, in at least float32 and in the JAX module's one-pass form
(``var = max(s2/count - mean**2, 0)``), with gradients flowing through
them. It then replaces the running buffers by torch-style updates
(``new = (1-m)*old + m*batch``, the running variance unbiased), assigned
as new tensors rather than written in place: under
``torch.func.functional_call`` the new values land in the caller's dict
and the tensors handed in stay as they were. Eval mode uses the running
statistics, folded into one scale and shift. The result is cast back to
the input's type in both modes.

Inside a mesh step (parallel/comm.py ``scope`` with a ``"data"`` group),
train mode all-reduces ``s1``, ``s2`` and the count over the data group
before the mean and variance, with autograd: the statistics, the running
update (its unbiased variance on the global count) and the input
gradients are those of one BatchNorm over the global batch (JAX
norm.py:60-74, its ``axis_name`` psums). Without a group it is the
single-device code.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import comm


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-5, momentum: float = 0.1, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.use_scale, self.use_bias = use_scale, use_bias
        if use_scale:
            self.scale = nn.Parameter(torch.ones(features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale', shift') in f32 with y = x * scale' + shift'."""
        s = torch.rsqrt(_at_least_f32(self.var) + self.epsilon)
        if self.use_scale:
            s = _at_least_f32(self.scale) * s
        shift = -_at_least_f32(self.mean) * s
        return s, shift + _at_least_f32(self.bias) if self.use_bias else shift

    def _batch_stats(self, xf: torch.Tensor, mask: Optional[torch.Tensor]):
        """(mean, biased var, count / max(count - 1, 1)) over every dim but
        1; a [B, T] mask of an [B, C, T] input leaves the padded frames out.
        Without a mask the count is a Python number: a tensor made from it
        on the card would be a blocking host-to-device copy."""
        dims = (0,) + tuple(range(2, xf.dim()))
        group = comm.data_group()
        if mask is not None:
            m = mask.to(xf.dtype)[:, None, :]
            count = m.sum()
            s1 = (xf * m).sum(dims)
            s2 = (xf * xf * m).sum(dims)
            if group is not None:
                c = xf.shape[1]
                sums = comm.all_reduce(torch.cat([s1, s2, count[None]]), group)
                s1, s2, count = sums[:c], sums[c:2 * c], sums[2 * c]
            count = torch.clamp_min(count, 1.0)
            bessel = count / torch.clamp_min(count - 1.0, 1.0)
        else:
            count = float(xf.numel() // xf.shape[1])
            s1 = xf.sum(dims)
            s2 = (xf * xf).sum(dims)
            if group is not None:
                # equal shards: the global count is a Python number too
                c = xf.shape[1]
                sums = comm.all_reduce(torch.cat([s1, s2]), group)
                s1, s2, count = sums[:c], sums[c:], count * group.size
            count = max(count, 1.0)
            bessel = count / max(count - 1.0, 1.0)
        mean = s1 / count
        return mean, torch.clamp_min(s2 / count - mean * mean, 0.0), bessel

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            # the affine is folded first: one f32 multiply-add over the
            # activations instead of four passes (differs from the unfolded
            # form in the last f32 bits only)
            s, t = self.folded()
            return torch.addcmul(t.view(shape), _at_least_f32(x), s.view(shape)).to(x.dtype)
        xf = _at_least_f32(x)
        mean, var, bessel = self._batch_stats(xf, mask)
        with torch.no_grad():
            m = self.momentum
            unbiased = var * bessel
            self.mean = ((1 - m) * self.mean + m * mean).to(self.mean.dtype)
            self.var = ((1 - m) * self.var + m * unbiased).to(self.var.dtype)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.epsilon)
        if self.use_scale:
            y = y * self.scale.view(shape)
        if self.use_bias:
            y = y + self.bias.view(shape)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with flax's parameter names (``scale``,
    ``bias``) and epsilon 1e-5 (torch's, the reference's), so weights map
    one to one; ``torch.nn.LayerNorm`` names its scale ``weight``. The
    statistics and the affine run in at least float32, as flax's do, and
    the result is cast back to the input's type."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.nn.functional.layer_norm(_at_least_f32(x), x.shape[-1:], _at_least_f32(self.scale),
                                           _at_least_f32(self.bias), self.epsilon)
        return y.to(x.dtype)
