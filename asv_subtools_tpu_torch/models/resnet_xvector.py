"""ResNet34 x-vector (counterpart:
asv_subtools_tpu/models/resnet_xvector.py:22-111).

A 2-D trunk over ``[B, T, F]`` fbank maps -> flattened frame features ->
pooling -> the embedding layers (the head of the TDNN family). The trunk
and the head's BatchNorms take no mask, in train mode either; the
pooling takes the mask subsampled to the trunk's frame rate, and runs
unfused in train mode. Every BatchNorm runs at momentum 0.5, the JAX
model's. Module and parameter names follow the flax modules.
RepVggXvector comes with nn/repvgg.py.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn.norm import BatchNorm
from ..nn.pooling import build_pooling
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
        h = self.resnet(x)  # [B, T', F'*C]
        sub_mask = None
        if mask is not None:
            t_out = h.shape[1]
            stride = max(1, x.shape[1] // t_out)
            sub_mask = mask[:, : t_out * stride : stride][:, :t_out]
        return self.head(h, sub_mask, position)
