"""TDNN building blocks (counterpart: asv_subtools_tpu/nn/tdnn.py:44-206, 362-376).

Inside the port's model activations are ``[B, C, T]``, the layout of
``F.conv1d``, so a layer needs no transpose. ``TdnnAffine`` covers evenly
spaced contexts (a dilated conv with zero "same" padding); irregular
contexts, int8 and groups come later. The layers hand a ``[B, T]`` mask
to their BatchNorm, whose train mode leaves padded frames out of the
batch statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm


def _context_info(context: Sequence[int]) -> Tuple[int, int]:
    """(dilation, kernel_size) of an evenly spaced sorted context."""
    ctx = list(context)
    if ctx != sorted(ctx):
        raise ValueError(f"context must be sorted, got {context}")
    if len(ctx) == 1:
        return 1, 1
    gaps = {ctx[i + 1] - ctx[i] for i in range(len(ctx) - 1)}
    if len(gaps) != 1:
        raise ValueError(f"only evenly spaced contexts are ported, got {context}")
    return gaps.pop(), len(ctx)


class TdnnAffine(nn.Module):
    """y_t = b + sum_i W_i x_{t+ctx_i}, zero-padded to keep T.

    x [B, C_in, T] -> [B, C_out, T]. ``conv.weight`` is ``[out, in, k]``.
    """

    def __init__(self, input_dim: int, output_dim: int, context: Sequence[int] = (0,)):
        super().__init__()
        dilation, ksize = _context_info(context)
        self.pad = (-context[0], context[-1])
        same = self.pad[0] == self.pad[1]
        self.conv = nn.Conv1d(input_dim, output_dim, ksize, dilation=dilation,
                              padding=self.pad[0] if same else 0)
        self._explicit_pad = not same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._explicit_pad:
            x = F.pad(x, self.pad)
        return self.conv(x)


class ActivationBatchNorm(nn.Module):
    """relu then BatchNorm (the ECAPA order, bn_relu=False)."""

    def __init__(self, features: int, momentum: float = 0.1):
        super().__init__()
        self.bn = BatchNorm(features, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.bn(torch.relu(x), mask)


class ReluBatchNormTdnnLayer(nn.Module):
    """TdnnAffine + ReLU + BN, the standard x-vector layer."""

    def __init__(self, input_dim: int, output_dim: int, context: Sequence[int] = (0,),
                 momentum: float = 0.1):
        super().__init__()
        self.affine = TdnnAffine(input_dim, output_dim, context)
        self.act_bn = ActivationBatchNorm(output_dim, momentum)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.act_bn(self.affine(x), mask)


class SEBlock2D(nn.Module):
    """Squeeze-and-excitation over (T, F) maps for the 2-D backbones.
    x [B, C, T, F]: the gate reads the mean over T and F."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(1, channels // ratio))
        self.fc2 = nn.Linear(max(1, channels // ratio), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(-2, -1))
        s = torch.relu(self.fc1(s))
        s = torch.sigmoid(self.fc2(s))
        return x * s[..., None, None]
