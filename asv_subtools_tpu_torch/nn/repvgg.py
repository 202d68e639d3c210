"""RepVGG backbone and its deploy-time reparameterization (counterpart:
asv_subtools_tpu/nn/repvgg.py:26-265).

A block trains with three branches and serves with one conv:

* ``block_type="vgg"``: a 3x3 conv + BN (``dense_conv``, ``dense_bn``), a
  1x1 conv + BN (``one_conv``, ``one_bn``) and, where the block keeps its
  shape, an identity BN (``id_bn``); deployed, one 3x3 conv;
* ``block_type="spk"`` (RepSPK, the RepVGG x-vector's default): the 3x3
  branch, a dilation-2 3x3 conv + BN (``dil_conv``, ``dil_bn``) and the
  identity BN; deployed, one dense 5x5 conv (the dilated kernel
  zero-interleaved into 5x5, the 3x3 padded by 1).

The deployed block's conv is ``reparam`` (with bias). ReLU follows the
branch sum, then the optional ``se`` (SEBlock2D, ratio 4). Padding is
symmetric: 1 for the 3x3, 2 for the dilated 3x3, 0 for the 1x1, 1 and 2
for the deployed 3x3 and 5x5.

Layout: as nn/resnet.py, ``[B, T, F]`` features in, ``[B, C, T, F]`` maps
in channels-last memory inside, ``[B, T', F'*C]`` out with f major. The
strided 1x1 conv runs over ``x[..., ::s, ::s]`` (the same arithmetic):
oneDNN's CPU backward of a strided 1x1 conv on channels-last maps
corrupts the heap.

:func:`repvgg_model_convert` folds a train-shape trunk's state_dict (its
weights and BN running statistics) into the deploy trunk's, on the
tensors' device and in their type; each BN folds with its own epsilon.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm
from .tdnn import SEBlock2D

Tensors = Dict[str, torch.Tensor]


class RepVGGBlock(nn.Module):
    """One re-parameterizable block: x [B, C_in, T, F] -> [B, C_out, T', F']."""

    def __init__(self, in_channels: int, out_channels: int, stride: Tuple[int, int] = (1, 1), groups: int = 1,
                 use_se: bool = False, deploy: bool = False, block_type: str = "vgg", momentum: float = 0.1):
        super().__init__()
        if block_type not in ("vgg", "spk"):
            raise ValueError(f"block_type must be 'vgg' or 'spk', got {block_type!r}")
        self.in_channels, self.out_channels, self.groups = in_channels, out_channels, groups
        self.stride, self.block_type, self.deploy = tuple(stride), block_type, deploy
        spk = block_type == "spk"
        if deploy:
            k, pad = (5, 2) if spk else (3, 1)
            self.reparam = nn.Conv2d(in_channels, out_channels, k, stride=stride, padding=pad, groups=groups)
        else:
            self.dense_conv = nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1, groups=groups,
                                        bias=False)
            self.dense_bn = BatchNorm(out_channels, momentum=momentum)
            if spk:
                self.dil_conv = nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=2, dilation=2,
                                          groups=groups, bias=False)
                self.dil_bn = BatchNorm(out_channels, momentum=momentum)
            else:
                self.one_conv = nn.Conv2d(in_channels, out_channels, 1, groups=groups, bias=False)
                self.one_bn = BatchNorm(out_channels, momentum=momentum)
            self.has_identity = in_channels == out_channels and self.stride == (1, 1)
            if self.has_identity:
                self.id_bn = BatchNorm(in_channels, momentum=momentum)
        self.se = SEBlock2D(out_channels, 4) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            y = self.reparam(x)
        else:
            y = self.dense_bn(self.dense_conv(x))
            if self.block_type == "spk":
                y = y + self.dil_bn(self.dil_conv(x))
            else:
                s_t, s_f = self.stride
                y = y + self.one_bn(self.one_conv(x[:, :, ::s_t, ::s_f]))
            if self.has_identity:
                y = y + self.id_bn(x)
        y = torch.relu(y)
        return y if self.se is None else self.se(y)


class RepVGG(nn.Module):
    """RepVGG trunk: ``[B, T, F]`` -> ``[B, T', F'*C]``. ``stage0`` maps the
    one input channel to ``min(64, int(base_channels * width_multiplier[0]))``
    channels (the reference's constant 64, not ``base_channels``); stage s
    (1-4) has ``num_blocks[s-1]`` blocks ``stage{s}_{b}`` of
    ``int(base_channels * 2**(s-1) * width_multiplier[s-1])`` channels, the
    first with ``strides[s-1]``. ``override_groups_map`` maps a block's
    index (``stage1_0`` is 1, stage0 always has groups 1) to its groups.
    The trunk takes no mask: its BatchNorms take their train-mode
    statistics over every frame."""

    def __init__(self, num_blocks: Sequence[int] = (2, 4, 14, 1),
                 width_multiplier: Sequence[float] = (0.75, 0.75, 0.75, 2.5), base_channels: int = 64,
                 override_groups_map: Optional[Mapping[int, int]] = None, use_se: bool = False,
                 deploy: bool = False, block: str = "vgg",
                 strides: Sequence[Tuple[int, int]] = ((1, 1), (2, 2), (2, 2), (2, 2)), momentum: float = 0.1):
        super().__init__()
        self.num_blocks, self.width_multiplier = tuple(num_blocks), tuple(width_multiplier)
        self.base_channels, self.block, self.strides = base_channels, block, tuple(map(tuple, strides))
        self.use_se, self.momentum = use_se, momentum
        self.override_groups_map = dict(override_groups_map or {})
        kw = dict(use_se=use_se, deploy=deploy, block_type=block, momentum=momentum)
        in_planes = min(64, int(base_channels * self.width_multiplier[0]))
        self.stage0 = RepVGGBlock(1, in_planes, **kw)
        self.blocks = [self.stage0]
        layer_idx = 1
        for stage in range(4):
            planes = int(base_channels * 2 ** stage * self.width_multiplier[stage])
            for b in range(self.num_blocks[stage]):
                stride = self.strides[stage] if b == 0 else (1, 1)
                blk = RepVGGBlock(in_planes, planes, stride, self.override_groups_map.get(layer_idx, 1), **kw)
                self.add_module(f"stage{stage + 1}_{b}", blk)
                self.blocks.append(blk)
                in_planes = planes
                layer_idx += 1
        self.out_planes = in_planes
        self.to(memory_format=torch.channels_last)  # the conv weights

    def output_dim(self, input_dim: int) -> int:
        """Width F'*C of the frame-level output for ``input_dim`` bins."""
        f = input_dim
        for stage, n in enumerate(self.num_blocks):
            if n:
                f = (f - 1) // self.strides[stage][1] + 1
        return f * self.out_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[:, None]  # [B, 1, T, F]
        x = self.stage0(x)
        # after stage0: a one-channel input's strides do not tell the two
        # formats apart, so cuDNN may have answered in NCHW
        x = x.contiguous(memory_format=torch.channels_last)
        for blk in self.blocks[1:]:
            x = blk(x)
        b, c, t, f = x.shape
        # [B, C, T', F'] -> [B, T', F', C] -> [B, T', F'*C], f major as in JAX
        return x.permute(0, 2, 3, 1).reshape(b, t, f * c)


def _fuse_bn(kernel: torch.Tensor, state: Mapping[str, torch.Tensor], bn: str,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BatchNorm ``bn`` of a block's ``state`` into ``kernel``
    ``[out, in/groups, kh, kw]``: (kernel * t, bias - mean * t) with
    t = scale / sqrt(var + eps)."""
    mean, var = state[f"{bn}.mean"], state[f"{bn}.var"]
    gamma = state.get(f"{bn}.scale", torch.ones_like(mean))
    beta = state.get(f"{bn}.bias", torch.zeros_like(mean))
    t = gamma / torch.sqrt(var + eps)
    return kernel * t[:, None, None, None], beta - mean * t


def reparameterize_block(block: RepVGGBlock, state: Mapping[str, torch.Tensor]) -> Tensors:
    """The train-shape ``block``'s branches, from its state_dict ``state``
    (keys relative to the block), folded into the deploy block's
    ``reparam.weight`` and ``reparam.bias``; ``se.*`` carries over.

    vgg: 3x3 + the 1x1 padded to 3x3 + identity -> 3x3. spk: the 3x3
    padded to 5x5 + the dilated 3x3 zero-interleaved into 5x5 + identity
    -> 5x5. The identity kernel is w[o, o % (in / groups), c, c] = 1."""
    if block.deploy:
        raise ValueError("the block is deployed already")
    eps = lambda name: getattr(block, name).epsilon
    k3, bias = _fuse_bn(state["dense_conv.weight"], state, "dense_bn", eps("dense_bn"))
    if block.block_type == "spk":
        kd, bd = _fuse_bn(state["dil_conv.weight"], state, "dil_bn", eps("dil_bn"))
        kernel = F.pad(k3, (1, 1, 1, 1))
        kernel[..., ::2, ::2] += kd
        bias = bias + bd
    else:
        k1, b1 = _fuse_bn(state["one_conv.weight"], state, "one_bn", eps("one_bn"))
        kernel = k3 + F.pad(k1, (1, 1, 1, 1))
        bias = bias + b1
    if block.has_identity:
        out_c, in_per_group, ksize = kernel.shape[0], kernel.shape[1], kernel.shape[-1]
        kid = torch.zeros_like(kernel)
        o = torch.arange(out_c, device=kernel.device)
        kid[o, o % in_per_group, ksize // 2, ksize // 2] = 1.0
        kid, bid = _fuse_bn(kid, state, "id_bn", eps("id_bn"))
        kernel, bias = kernel + kid, bias + bid
    out = {"reparam.weight": kernel, "reparam.bias": bias}
    out.update({k: v for k, v in state.items() if k.startswith("se.")})
    return out


def repvgg_model_convert(model: RepVGG, state: Optional[Mapping[str, torch.Tensor]] = None) -> Tensors:
    """A train-shape trunk's state_dict (``model``'s own by default) ->
    the state_dict of the same trunk built with ``deploy=True``."""
    state = model.state_dict() if state is None else state
    out: Tensors = {}
    for name, blk in model.named_children():
        prefix = name + "."
        folded = reparameterize_block(blk, {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})
        out.update({prefix + k: v for k, v in folded.items()})
    return out


def repvgg_a0(**kw) -> RepVGG:
    return RepVGG(num_blocks=(2, 4, 14, 1), width_multiplier=(0.75, 0.75, 0.75, 2.5), **kw)


def repvgg_a1(**kw) -> RepVGG:
    return RepVGG(num_blocks=(2, 4, 14, 1), width_multiplier=(1, 1, 1, 2.5), **kw)


def repvgg_a2(**kw) -> RepVGG:
    return RepVGG(num_blocks=(2, 4, 14, 1), width_multiplier=(1.5, 1.5, 1.5, 2.75), **kw)


def repvgg_b0(**kw) -> RepVGG:
    return RepVGG(num_blocks=(4, 6, 16, 1), width_multiplier=(1, 1, 1, 2.5), **kw)


def repvgg_b1(**kw) -> RepVGG:
    return RepVGG(num_blocks=(4, 6, 16, 1), width_multiplier=(2, 2, 2, 4), **kw)
