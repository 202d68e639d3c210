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
recipe; "linear", "conv2d6", "conv2d8" and "re_conv2d" raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


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


SUBSAMPLINGS = {"conv2d": Conv2dSubsampling4, "conv2d2": Conv2dSubsampling2}


def make_subsampling(input_layer: str, input_dim: int, odim: int) -> Conv2dSubsampling:
    if input_layer in ("linear", "conv2d6", "conv2d8", "re_conv2d"):
        raise NotImplementedError(f"input_layer {input_layer!r} is not ported yet")
    if input_layer not in SUBSAMPLINGS:
        raise ValueError(f"unknown input_layer {input_layer!r}")
    return SUBSAMPLINGS[input_layer](input_dim, odim)
