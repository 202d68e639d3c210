"""Convolutional input subsampling (counterpart:
asv_subtools_tpu/nn/conformer/subsampling.py:41-74).

``[B, T, F]`` features -> two VALID 3x3 convs with relu over the
``[B, C, T, F]`` map -> ``[B, T', F'*C]`` -> a Dense to the attention
width. JAX's maps are ``[B, T, F, C]`` and flatten with C fastest; the
port permutes to that order first (the map is held in
``torch.channels_last`` memory, where the permutation and the flatten are
views), so ``proj`` takes the JAX weight as it is. The mask is strided to
the subsampled rate from the offset of the convs' receptive field.
"conv2d" (4x) and "conv2d2" (2x) are ported, the two rates of the
recipe, and the ReConformer's "re_conv2d" (4x); "linear", "conv2d6" and
"conv2d8" raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..activations import double_swish
from .scaling import BasicNorm, activation_balancer


def _valid(n: int, stride: int) -> int:
    return (n - 3) // stride + 1


class Conv2dSubsampling(nn.Module):
    """Two 3x3 VALID convs at ``strides`` (per conv, (time, frequency)),
    then ``proj``; the mask becomes ``mask[:, offset::factor][:, :T']``."""

    def __init__(self, input_dim: int, odim: int, strides: Tuple[Tuple[int, int], Tuple[int, int]],
                 factor: int, offset: int):
        super().__init__()
        self.factor, self.offset = factor, offset
        self.conv1 = nn.Conv2d(1, odim, 3, stride=strides[0])
        self.conv2 = nn.Conv2d(odim, odim, 3, stride=strides[1])
        f = _valid(_valid(input_dim, strides[0][1]), strides[1][1])
        self.proj = nn.Linear(f * odim, odim)
        self.to(memory_format=torch.channels_last)  # the conv weights

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x [B, T, F], mask [B, T] -> ([B, T', odim], mask [B, T'] or None)."""
        h = torch.relu(self.conv1(x[:, None]))
        h = torch.relu(self.conv2(h.contiguous(memory_format=torch.channels_last)))
        b, c, t, f = h.shape
        h = self.proj(h.permute(0, 2, 3, 1).reshape(b, t, f * c))
        if mask is not None:
            mask = mask[:, self.offset::self.factor][:, :t]
        return h, mask


def Conv2dSubsampling4(input_dim: int, odim: int) -> Conv2dSubsampling:
    """1/4 rate: two stride-2 convs (wenet Conv2dSubsampling4)."""
    return Conv2dSubsampling(input_dim, odim, ((2, 2), (2, 2)), factor=4, offset=6)


def Conv2dSubsampling2(input_dim: int, odim: int) -> Conv2dSubsampling:
    """1/2 rate: stride 2 over time only, then stride 1: F' = F - 4."""
    return Conv2dSubsampling(input_dim, odim, ((2, 1), (1, 1)), factor=2, offset=2)


class ReConv2dSubsampling4(nn.Module):
    """The ReConformer's 1/4 rate (JAX subsampling.py:110-151): convs to 8,
    32 and 128 channels (the first 3x3 at stride 1 with padding 1, then
    two 3x3 at stride 2, VALID), each followed by a balancer and
    double_swish, then ``proj``, a fixed-eps BasicNorm (``out_norm``) and
    a balancer (0.45..0.55 positive). The mask is strided as conv2d's."""

    factor, offset = 4, 6

    def __init__(self, input_dim: int, odim: int, layer1_channels: int = 8, layer2_channels: int = 32,
                 layer3_channels: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(1, layer1_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(layer1_channels, layer2_channels, 3, stride=2)
        self.conv3 = nn.Conv2d(layer2_channels, layer3_channels, 3, stride=2)
        self.proj = nn.Linear(_valid(_valid(input_dim, 2), 2) * layer3_channels, odim)
        self.out_norm = BasicNorm(learn_eps=False)
        self.to(memory_format=torch.channels_last)  # the conv weights

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x [B, T, F], mask [B, T] -> ([B, T', odim], mask [B, T'] or None)."""
        h = x[:, None]
        for conv in (self.conv1, self.conv2, self.conv3):
            h = double_swish(activation_balancer(conv(h.contiguous(memory_format=torch.channels_last)), 1))
        b, c, t, f = h.shape
        h = self.proj(h.permute(0, 2, 3, 1).reshape(b, t, f * c))
        h = activation_balancer(self.out_norm(h), -1, 0.45, 0.55)
        if mask is not None:
            mask = mask[:, self.offset::self.factor][:, :t]
        return h, mask


SUBSAMPLINGS = {"conv2d": Conv2dSubsampling4, "conv2d2": Conv2dSubsampling2, "re_conv2d": ReConv2dSubsampling4}


def make_subsampling(input_layer: str, input_dim: int, odim: int) -> nn.Module:
    if input_layer in ("linear", "conv2d6", "conv2d8"):
        raise NotImplementedError(f"input_layer {input_layer!r} is not ported yet (ROADMAP Queue 1 item 3)")
    if input_layer not in SUBSAMPLINGS:
        raise ValueError(f"unknown input_layer {input_layer!r}")
    return SUBSAMPLINGS[input_layer](input_dim, odim)
