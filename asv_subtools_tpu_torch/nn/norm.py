"""BatchNorm in eval semantics (counterpart: asv_subtools_tpu/nn/norm.py:26-88).

``y = (x - mean) * rsqrt(var + eps) * scale + bias``, with the statistics
and the arithmetic in at least float32 and the result cast back to the
input's type, as the JAX module does. Parameters and buffers keep the
flax names (``scale``, ``bias``, ``mean``, ``var``) so weights map one to
one. Features sit on dim 1 (``[B, C]`` or ``[B, C, T]``), the layout the
port's model holds. Train-mode masked statistics come with the training
slice.
"""

from __future__ import annotations

import torch
from torch import nn


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale', shift') in f32 with y = x * scale' + shift'."""
        s = _at_least_f32(self.scale) * torch.rsqrt(_at_least_f32(self.var) + self.epsilon)
        return s, _at_least_f32(self.bias) - _at_least_f32(self.mean) * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the affine is folded first: one f32 multiply-add over the
        # activations instead of four passes (differs from the unfolded
        # form in the last f32 bits only)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        s, t = self.folded()
        return torch.addcmul(t.view(shape), _at_least_f32(x), s.view(shape)).to(x.dtype)
