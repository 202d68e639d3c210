"""ResNet34 and RepVGG x-vectors (counterpart:
asv_subtools_tpu/models/resnet_xvector.py:22-165).

A 2-D trunk over ``[B, T, F]`` fbank maps -> flattened frame features ->
pooling -> the embedding layers (the head of the TDNN family). The trunk
and the head's BatchNorms take no mask, in train mode either; the
pooling takes the mask subsampled to the trunk's frame rate, and runs
unfused in train mode. Every BatchNorm runs at momentum 0.5, the JAX
model's. Module and parameter names follow the flax modules.
:func:`deploy_repvgg_xvector` folds a trained RepVggXvector's trunk into
its deploy shape (one conv a block) and keeps its head.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn.norm import BatchNorm
from ..nn.pooling import build_pooling
from ..nn.repvgg import RepVGG, repvgg_model_convert
from ..nn.resnet import ResNet


class _EmbeddingHead(nn.Module):
    """stats-pool -> [fc1 (affine, relu, bn)] -> fc2 (affine, relu, bn).

    fc1 is optional (off by default: the pooling feeds fc2 directly).
    ``position`` picks the embedding: "far" = fc1's affine output (needs
    fc1), "near_affine" = fc2's affine output, "near" = after relu and BN.
    """

    def __init__(self, input_dim: int, embd_dim: int = 512, pooling: str = "statistics",
                 pooling_params: Optional[dict] = None, fc1: bool = False, momentum: float = 0.5):
        super().__init__()
        self.stats = build_pooling(pooling, input_dim, pooling_params)
        dim = self.stats.output_dim(input_dim)
        self.has_fc1 = fc1
        if fc1:
            self.fc1_affine = nn.Linear(dim, embd_dim)
            self.fc1_bn = BatchNorm(embd_dim, momentum=momentum)
            dim = embd_dim
        self.fc2_affine = nn.Linear(dim, embd_dim)
        self.fc2_bn = BatchNorm(embd_dim, momentum=momentum)

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor], position: str) -> torch.Tensor:
        if position not in ("near", "near_affine", "far"):
            raise ValueError(f"position must be near, near_affine or far, got {position!r}")
        if position == "far" and not self.has_fc1:
            raise ValueError("position='far' requires fc1=True")
        z = self.stats(h, mask)
        if self.has_fc1:
            z = self.fc1_affine(z)
            if position == "far":
                return z
            z = self.fc1_bn(torch.relu(z))
        z = self.fc2_affine(z)
        if position == "near_affine":
            return z
        return self.fc2_bn(torch.relu(z))


class ResNetXvector(nn.Module):
    """ResNet34 x-vector. The defaults are the base32 voxceleb recipe (basic
    blocks, layers 3-4-6-3, 32 channels, statistics pooling, embedding 512).

    Built on ``device`` (the CUDA card unless ``device="cpu"``; raises
    without a card), in eval mode. Cast with ``.to(torch.bfloat16)`` for
    serving; training runs it in train mode (train/trainer.py).
    ``pooling_params={"fused_inference": True}`` runs the statistics
    pooling through its fused kernel at inference.
    """

    def __init__(
        self,
        input_dim: int = 80,
        block: str = "basic",
        layers: Sequence[int] = (3, 4, 6, 3),
        base_planes: int = 32,
        use_se: bool = False,
        full_pre_activation: bool = True,
        embd_dim: int = 512,
        pooling: str = "statistics",
        pooling_params: Optional[dict] = None,
        fc1: bool = False,
        momentum: float = 0.5,
        device: Any = None,
    ):
        super().__init__()
        self.embd_dim = embd_dim
        self.resnet = ResNet(block=block, layers=layers, base_planes=base_planes, use_se=use_se,
                             full_pre_activation=full_pre_activation, momentum=momentum)
        self.head = _EmbeddingHead(self.resnet.output_dim(input_dim), embd_dim=embd_dim,
                                   pooling=pooling, pooling_params=pooling_params, fc1=fc1,
                                   momentum=momentum)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                position: str = "near") -> torch.Tensor:
        """x [B, T, F], mask [B, T] -> embedding [B, embd_dim]."""
        return self.head(*_trunk_and_mask(self.resnet, x, mask), position)


def _trunk_and_mask(trunk: nn.Module, x: torch.Tensor, mask: Optional[torch.Tensor]):
    """(frames [B, T', F'*C], the mask subsampled to T' frames)."""
    h = trunk(x)
    if mask is None:
        return h, None
    t_out = h.shape[1]
    stride = max(1, x.shape[1] // t_out)
    return h, mask[:, : t_out * stride : stride][:, :t_out]


class RepVggXvector(nn.Module):
    """RepVGG x-vector. The defaults are the reference's RepVGG config
    (RepSPK blocks, base 32, blocks 2-4-14-1, width (1, 1, 1, 2.5),
    statistics pooling, embedding 256, momentum 0.5).

    ``deploy=True`` builds the trunk with one conv a block (``reparam``):
    :func:`deploy_repvgg_xvector` makes one from a trained model. Built on
    ``device`` (the CUDA card unless ``device="cpu"``; raises without a
    card), in eval mode. ``pooling_params={"fused_inference": True}`` runs
    the statistics pooling through its fused kernel at inference.
    """

    def __init__(
        self,
        input_dim: int = 80,
        num_blocks: Sequence[int] = (2, 4, 14, 1),
        width_multiplier: Sequence[float] = (1.0, 1.0, 1.0, 2.5),
        base_channels: int = 32,
        block: str = "spk",
        deploy: bool = False,
        use_se: bool = False,
        embd_dim: int = 256,
        pooling: str = "statistics",
        pooling_params: Optional[dict] = None,
        momentum: float = 0.5,
        device: Any = None,
    ):
        super().__init__()
        self.config = dict(input_dim=input_dim, num_blocks=tuple(num_blocks),
                           width_multiplier=tuple(width_multiplier), base_channels=base_channels, block=block,
                           use_se=use_se, embd_dim=embd_dim, pooling=pooling, pooling_params=pooling_params,
                           momentum=momentum)
        self.embd_dim = embd_dim
        self.repvgg = RepVGG(num_blocks=num_blocks, width_multiplier=width_multiplier, base_channels=base_channels,
                             use_se=use_se, deploy=deploy, block=block, momentum=momentum)
        self.head = _EmbeddingHead(self.repvgg.output_dim(input_dim), embd_dim=embd_dim, pooling=pooling,
                                   pooling_params=pooling_params, momentum=momentum)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                position: str = "near") -> torch.Tensor:
        """x [B, T, F], mask [B, T] -> embedding [B, embd_dim]."""
        return self.head(*_trunk_and_mask(self.repvgg, x, mask), position)


def deploy_repvgg_xvector(model: RepVggXvector,
                          state: Optional[Mapping[str, torch.Tensor]] = None) -> RepVggXvector:
    """The deploy shape of a train-shape RepVggXvector: a new model with
    ``deploy=True`` on ``model``'s device and in its type, holding the
    trunk folded from ``state`` (``model``'s state_dict by default: its
    weights and BN running statistics) and the head's weights and
    statistics as they are."""
    state = model.state_dict() if state is None else state
    p = next(model.parameters())
    deployed = RepVggXvector(**model.config, deploy=True, device=p.device).to(p.dtype)
    trunk = repvgg_model_convert(model.repvgg, {k[len("repvgg."):]: v for k, v in state.items()
                                                if k.startswith("repvgg.")})
    deployed.load_state_dict({**{f"repvgg.{k}": v for k, v in trunk.items()},
                              **{k: v for k, v in state.items() if not k.startswith("repvgg.")}})
    return deployed
