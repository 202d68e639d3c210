"""2-D ResNet backbone over spectrogram maps (counterpart:
asv_subtools_tpu/nn/resnet.py:21-205).

Layout: the public input is ``[B, T, F]`` features; inside the trunk maps
are ``[B, C, T, F]`` (H = T, W = F), the layout of ``F.conv2d``. The JAX
trunk is channels-last ``[B, T, F, C]`` and flattens to ``[B, T', F'*C]``
with f major; the port permutes to that order before it flattens, so the
first Dense after the pooling takes the JAX weight as it is. The maps are
held in ``torch.channels_last`` memory, where that permutation and the
flatten are views and cuDNN runs its NHWC kernels.

Convolutions are ``nn.Conv2d`` (cuDNN), as the JAX package leaves them to
XLA; flax ``padding=[(1, 1), (1, 1)]`` with stride 2 is torch
``padding=1``. Module names follow the flax modules, so weights.py maps a
JAX variable tree onto this state_dict by rule.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm
from .tdnn import SEBlock2D


def _conv3x3(in_planes: int, planes: int, stride: Tuple[int, int] = (1, 1)) -> nn.Conv2d:
    return nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)


def _add_downsample(block: nn.Module, in_planes: int, out_planes: int, stride: Tuple[int, int],
                    momentum: float) -> None:
    """A 1x1 strided conv + BN on the residual, where its shape changes."""
    block.has_downsample = tuple(stride) != (1, 1) or in_planes != out_planes
    if block.has_downsample:
        block.downsample_stride = tuple(stride)
        block.downsample_conv = nn.Conv2d(in_planes, out_planes, 1, bias=False)
        block.downsample_bn = BatchNorm(out_planes, momentum=momentum)


def _downsample(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The strided 1x1 conv as a 1x1 conv over the cells it reads,
    ``x[..., ::s_t, ::s_f]`` (the same arithmetic): oneDNN's CPU backward
    of a strided 1x1 conv on channels-last maps corrupts the heap."""
    s_t, s_f = block.downsample_stride
    return block.downsample_bn(block.downsample_conv(x[:, :, ::s_t, ::s_f]))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block. ``full_pre_activation=True`` (He et al.
    2016): bn-relu-conv twice, the identity added without a final relu;
    False is the original conv-bn-relu order."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: Tuple[int, int] = (1, 1),
                 use_se: bool = False, se_ratio: int = 16, full_pre_activation: bool = True,
                 momentum: float = 0.1):
        super().__init__()
        self.full_pre_activation = full_pre_activation
        self.bn1 = BatchNorm(in_planes if full_pre_activation else planes, momentum=momentum)
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn2 = BatchNorm(planes, momentum=momentum)
        self.conv2 = _conv3x3(planes, planes)
        self.se = SEBlock2D(planes, se_ratio) if use_se else None
        _add_downsample(self, in_planes, planes, stride, momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.full_pre_activation:
            y = self.conv1(torch.relu(self.bn1(x)))
            y = self.conv2(torch.relu(self.bn2(y)))
        else:
            y = torch.relu(self.bn1(self.conv1(x)))
            y = self.bn2(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        if self.has_downsample:
            residual = _downsample(self, residual)
        y = y + residual
        return y if self.full_pre_activation else torch.relu(y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: Tuple[int, int] = (1, 1),
                 use_se: bool = False, se_ratio: int = 16, momentum: float = 0.1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, momentum=momentum)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn2 = BatchNorm(planes, momentum=momentum)
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm(out_planes, momentum=momentum)
        self.se = SEBlock2D(out_planes, se_ratio) if use_se else None
        _add_downsample(self, in_planes, out_planes, stride, momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        if self.has_downsample:
            residual = _downsample(self, residual)
        return torch.relu(y + residual)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, with the "SAME" padding of flax's max_pool
    (-inf; one more cell after than before when the total is odd)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, stride=2)


class ResNet(nn.Module):
    """ResNet trunk for x-vectors: ``[B, T, F]`` -> frame-level
    ``[B, T', F'*C]`` with T' ~ T/8. The defaults (layers 3-4-6-3, base 32)
    are the voxceleb ResNet34 recipe. The trunk takes no mask, in train
    mode either: its BatchNorms take their statistics over every frame.
    ``momentum`` is the BatchNorms' (JAX's trunk default, 0.1;
    ResNetXvector passes 0.5)."""

    def __init__(self, block: str = "basic", layers: Sequence[int] = (3, 4, 6, 3),
                 base_planes: int = 32, use_se: bool = False, se_ratio: int = 16,
                 full_pre_activation: bool = True, head_conv: bool = True,
                 head_maxpool: bool = False, momentum: float = 0.1):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        self.head_conv, self.head_maxpool = head_conv, head_maxpool
        in_planes = 1
        if head_conv:
            self.stem = _conv3x3(1, base_planes)
            self.stem_bn = BatchNorm(base_planes, momentum=momentum)
            in_planes = base_planes
        self.blocks = []
        for stage, n_blocks in enumerate(layers):
            planes = base_planes * 2 ** stage
            for b in range(n_blocks):
                stride = (2, 2) if stage > 0 and b == 0 else (1, 1)
                if block == "basic":
                    blk = BasicBlock(in_planes, planes, stride, use_se, se_ratio, full_pre_activation, momentum)
                else:
                    blk = Bottleneck(in_planes, planes, stride, use_se, se_ratio, momentum)
                self.add_module(f"layer{stage + 1}_{b}", blk)
                self.blocks.append(blk)
                in_planes = planes * blk.expansion
        self.out_planes = in_planes
        self.reductions = (1 if head_maxpool else 0) + len(layers) - 1
        self.to(memory_format=torch.channels_last)  # the conv weights

    def output_dim(self, input_dim: int) -> int:
        """Width F'*C of the frame-level output for ``input_dim`` bins."""
        f = input_dim
        for _ in range(self.reductions):
            f = (f - 1) // 2 + 1
        return f * self.out_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[:, None]  # [B, 1, T, F]
        if self.head_conv:
            x = self.stem(x)
        # after the stem: a one-channel map's strides do not tell the two
        # formats apart, so cuDNN may have answered in NCHW
        x = x.contiguous(memory_format=torch.channels_last)
        if self.head_conv:
            x = torch.relu(self.stem_bn(x))
        if self.head_maxpool:
            x = _max_pool_same(x)
        for blk in self.blocks:
            x = blk(x)
        b, c, t, f = x.shape
        # [B, C, T', F'] -> [B, T', F', C] -> [B, T', F'*C], f major as in JAX
        return x.permute(0, 2, 3, 1).reshape(b, t, f * c)


def resnet18(**kw) -> ResNet:
    return ResNet(block="basic", layers=(2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(block="basic", layers=(3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), **kw)
