"""The Conformer's convolution module (counterpart:
asv_subtools_tpu/nn/conformer/convolution.py:20-81).

x [B, T, D] masked -> pointwise conv to 2D -> GLU -> depthwise conv
(kernel 15, "SAME" padding, one group per channel) -> norm -> swish ->
pointwise conv -> masked. The pointwise convs keep the ``Conv1d`` weight
layout ``[out, in, 1]`` (the flax kernel ``[1, in, out]`` by the 1-D
rule) and run as products over the channels-last input; the depthwise
conv runs over the transposed ``[B, D, T]`` view. ``norm_type``
"layer_norm" (the encoder's), "batch_norm" (the masked BatchNorm) or
"basic_norm". The ReConformer's options: ``use_balancer`` (a balancer
after the first pointwise conv and after the norm), ``re_module`` (no
norm at all) and the "double_swish" activation (any other name is
swish, as in JAX). ``causal`` pads the depthwise conv on the left only
(k - 1 frames, JAX convolution.py:48-51), for the chunk masks of
streaming training.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..activations import double_swish, swish
from ..norm import BatchNorm, LayerNorm
from .scaling import BasicNorm, activation_balancer


def pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-1 ``Conv1d`` over channels-last x [B, T, C_in]."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 15, norm_type: str = "batch_norm", causal: bool = False,
                 momentum: float = 0.1, use_balancer: bool = False, re_module: bool = False,
                 activation: str = "swish"):
        super().__init__()
        self.kernel_size, self.norm_type, self.causal = kernel_size, norm_type, causal
        self.use_balancer, self.re_module = use_balancer, re_module
        self.act = double_swish if activation == "double_swish" else swish
        self.pointwise1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise = nn.Conv1d(channels, channels, kernel_size, groups=channels)
        if re_module:
            self.norm = None
        elif norm_type == "batch_norm":
            self.norm = BatchNorm(channels, momentum=momentum)
        elif norm_type == "layer_norm":
            self.norm = LayerNorm(channels)
        elif norm_type == "basic_norm":
            self.norm = BasicNorm()
        else:
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.pointwise2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, D], mask [B, T] -> [B, T, D]."""
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        h = pointwise(self.pointwise1, x)
        if self.use_balancer:
            h = activation_balancer(h, -1, 0.05, 1.0, 0.01, 0.2, 10.0)
        h = F.glu(h, dim=-1)
        k = self.kernel_size
        h = F.pad(h.transpose(1, 2), (k - 1, 0) if self.causal else ((k - 1) // 2, k // 2))  # or flax "SAME"
        h = F.conv1d(h, self.depthwise.weight, self.depthwise.bias, groups=self.depthwise.groups)
        if self.norm is None:
            h = h.transpose(1, 2)
        elif self.norm_type == "batch_norm":
            h = self.norm(h, mask).transpose(1, 2)
        else:
            h = self.norm(h.transpose(1, 2))
        if self.use_balancer:
            h = activation_balancer(h, -1, 0.05, 1.0, 0.01, 0.2, 100.0)
        h = pointwise(self.pointwise2, self.act(h))
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        return h
