"""The Conformer's convolution module (counterpart:
asv_subtools_tpu/nn/conformer/convolution.py:20-81).

x [B, T, D] masked -> pointwise conv to 2D -> GLU -> depthwise conv
(kernel 15, "SAME" padding, one group per channel) -> norm -> swish ->
pointwise conv -> masked. The pointwise convs keep the ``Conv1d`` weight
layout ``[out, in, 1]`` (the flax kernel ``[1, in, out]`` by the 1-D
rule) and run as products over the channels-last input; the depthwise
conv runs over the transposed ``[B, D, T]`` view. ``norm_type``
"layer_norm" (the encoder's) or "batch_norm" (the masked BatchNorm);
"basic_norm", ``causal``, the balancer and the ReConformer module raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..norm import BatchNorm, LayerNorm


def pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-1 ``Conv1d`` over channels-last x [B, T, C_in]."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 15, norm_type: str = "batch_norm", causal: bool = False,
                 momentum: float = 0.1, use_balancer: bool = False, re_module: bool = False,
                 activation: str = "swish"):
        super().__init__()
        for name, value, off in (("causal", causal, False), ("use_balancer", use_balancer, False),
                                 ("re_module", re_module, False), ("activation", activation, "swish")):
            if value != off:
                raise NotImplementedError(f"ConvolutionModule option {name}={value!r} is not ported yet")
        if norm_type == "basic_norm":
            raise NotImplementedError("norm_type 'basic_norm' is not ported yet")
        if norm_type not in ("batch_norm", "layer_norm"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.kernel_size, self.norm_type = kernel_size, norm_type
        self.pointwise1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise = nn.Conv1d(channels, channels, kernel_size, groups=channels)
        self.norm = (BatchNorm(channels, momentum=momentum) if norm_type == "batch_norm"
                     else LayerNorm(channels))
        self.pointwise2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, D], mask [B, T] -> [B, T, D]."""
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        h = F.glu(pointwise(self.pointwise1, x), dim=-1)
        k = self.kernel_size
        h = F.pad(h.transpose(1, 2), ((k - 1) // 2, k // 2))  # flax "SAME"
        h = F.conv1d(h, self.depthwise.weight, self.depthwise.bias, groups=self.depthwise.groups)
        if self.norm_type == "batch_norm":
            h = self.norm(h, mask).transpose(1, 2)
        else:
            h = self.norm(h.transpose(1, 2))
        h = pointwise(self.pointwise2, h * torch.sigmoid(h))
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        return h
