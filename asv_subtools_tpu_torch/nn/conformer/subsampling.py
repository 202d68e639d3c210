"""Input subsampling (counterpart: asv_subtools_tpu/nn/conformer/subsampling.py:19-154).

``[B, T, F]`` features -> VALID convs with relu over the ``[B, C, T, F]``
map -> ``[B, T', F'*C]`` -> a Dense to the attention width. JAX's maps
are ``[B, T, F, C]`` and flatten with C fastest; the port permutes to
that order first (the map is held in ``torch.channels_last`` memory,
where the permutation and the flatten are views), so ``proj`` takes the
JAX weight as it is. The mask is strided to the subsampled rate from the
offset of the convs' receptive field (JAX ``_subsample_mask``, :19-23):
``mask[:, offset::factor][:, :T']``.

"conv2d2" (2x: 3x3 at stride (2, 1), then 3x3, JAX :41-58), "conv2d"
(4x: two 3x3 at stride 2, :61-74), "conv2d6" (6x: 3x3 at stride 2, then
5x5 at stride 3, :77-90), "conv2d8" (8x: three 3x3 at stride 2,
:93-107), the ReConformer's "re_conv2d" (4x, :110-151) and "linear"
(``LinearNoSubsampling``: Dense + LayerNorm at 1x, dropout in train
mode from the step's generator, :26-38).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..activations import double_swish
from ..dropout import dropout
from ..norm import LayerNorm
from .scaling import BasicNorm, activation_balancer


def _valid(n: int, stride: int, kernel: int = 3) -> int:
    return (n - kernel) // stride + 1


class Conv2dSubsampling(nn.Module):
    """VALID convs ``conv1``, ``conv2``, ... of ``layers`` ((kernel,
    (time stride, frequency stride)) each) with relu, then ``proj``; the
    mask becomes ``mask[:, offset::factor][:, :T']``."""

    def __init__(self, input_dim: int, odim: int, layers: Sequence[Tuple[int, Tuple[int, int]]], factor: int,
                 offset: int):
        super().__init__()
        self.factor, self.offset = factor, offset
        self.convs = []
        f = input_dim
        for i, (kernel, stride) in enumerate(layers):
            conv = nn.Conv2d(1 if i == 0 else odim, odim, kernel, stride=stride)
            self.add_module(f"conv{i + 1}", conv)
            self.convs.append(conv)
            f = _valid(f, stride[1], kernel)
        self.proj = nn.Linear(f * odim, odim)
        self.to(memory_format=torch.channels_last)  # the conv weights

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x [B, T, F], mask [B, T] -> ([B, T', odim], mask [B, T'] or None)."""
        h = x[:, None]
        for i, conv in enumerate(self.convs):
            h = torch.relu(conv(h if i == 0 else h.contiguous(memory_format=torch.channels_last)))
        b, c, t, f = h.shape
        h = self.proj(h.permute(0, 2, 3, 1).reshape(b, t, f * c))
        if mask is not None:
            mask = mask[:, self.offset::self.factor][:, :t]
        return h, mask


def Conv2dSubsampling4(input_dim: int, odim: int, dropout_rate: float = 0.0) -> Conv2dSubsampling:
    """1/4 rate: two stride-2 convs (wenet Conv2dSubsampling4)."""
    return Conv2dSubsampling(input_dim, odim, ((3, (2, 2)), (3, (2, 2))), factor=4, offset=6)


def Conv2dSubsampling2(input_dim: int, odim: int, dropout_rate: float = 0.0) -> Conv2dSubsampling:
    """1/2 rate: stride 2 over time only, then stride 1: F' = F - 4."""
    return Conv2dSubsampling(input_dim, odim, ((3, (2, 1)), (3, (1, 1))), factor=2, offset=2)


def Conv2dSubsampling6(input_dim: int, odim: int, dropout_rate: float = 0.0) -> Conv2dSubsampling:
    """1/6 rate: a 3x3 conv at stride 2, then a 5x5 conv at stride 3."""
    return Conv2dSubsampling(input_dim, odim, ((3, (2, 2)), (5, (3, 3))), factor=6, offset=10)


def Conv2dSubsampling8(input_dim: int, odim: int, dropout_rate: float = 0.0) -> Conv2dSubsampling:
    """1/8 rate: three 3x3 convs at stride 2."""
    return Conv2dSubsampling(input_dim, odim, ((3, (2, 2)), (3, (2, 2)), (3, (2, 2))), factor=8, offset=14)


class LinearNoSubsampling(nn.Module):
    """1x rate: ``proj`` (Dense) -> ``norm`` (LayerNorm, eps 1e-5) ->
    dropout in train mode; the mask passes as it is."""

    def __init__(self, input_dim: int, odim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.proj = nn.Linear(input_dim, odim)
        self.norm = LayerNorm(odim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = self.norm(self.proj(x))
        if self.dropout_rate > 0 and self.training:
            h = dropout(h, self.dropout_rate, generator)
        return h, mask


class ReConv2dSubsampling4(nn.Module):
    """The ReConformer's 1/4 rate (JAX subsampling.py:110-151): convs to 8,
    32 and 128 channels (the first 3x3 at stride 1 with padding 1, then
    two 3x3 at stride 2, VALID), each followed by a balancer and
    double_swish, then ``proj``, a fixed-eps BasicNorm (``out_norm``) and
    a balancer (0.45..0.55 positive). The mask is strided as conv2d's."""

    factor, offset = 4, 6

    def __init__(self, input_dim: int, odim: int, dropout_rate: float = 0.0, layer1_channels: int = 8,
                 layer2_channels: int = 32, layer3_channels: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(1, layer1_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(layer1_channels, layer2_channels, 3, stride=2)
        self.conv3 = nn.Conv2d(layer2_channels, layer3_channels, 3, stride=2)
        self.proj = nn.Linear(_valid(_valid(input_dim, 2), 2) * layer3_channels, odim)
        self.out_norm = BasicNorm(learn_eps=False)
        self.to(memory_format=torch.channels_last)  # the conv weights

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
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


SUBSAMPLINGS = {"linear": LinearNoSubsampling, "conv2d2": Conv2dSubsampling2, "conv2d": Conv2dSubsampling4,
                "re_conv2d": ReConv2dSubsampling4, "conv2d6": Conv2dSubsampling6, "conv2d8": Conv2dSubsampling8}


def make_subsampling(input_layer: str, input_dim: int, odim: int, dropout_rate: float = 0.0) -> nn.Module:
    """The subsampling of ``input_layer``; only "linear" uses the dropout."""
    if input_layer not in SUBSAMPLINGS:
        raise ValueError(f"unknown input_layer {input_layer!r}")
    return SUBSAMPLINGS[input_layer](input_dim, odim, dropout_rate)
