"""Multi-task and feature-decomposition x-vectors (counterpart:
asv_subtools_tpu/models/multitask.py; parity:
pytorch/model/multi_task_xvector_fix.py and snowdar-xvector-FD-AL.py).

Both share the snowdar trunk (tdnn1 .. tdnn4, models/xvector.py
``build_snowdar_trunk``) and the speaker branch tdnn5 (1500) -> pooling ->
tdnn6 -> tdnn7, under the flax module names, so weights.py carries a JAX
variable tree onto them by rule. ``MultiTaskXvector`` adds the phonetic
branch ``phonetic_tdnn5`` .. ``phonetic_tdnn7`` on the trunk and returns
``(embedding, phone_feats [B, T, C])``; ``FDXvector`` splits the tdnn7
embedding by an SE gate (``att_fc1``, ``att_fc2``) into a speaker part
and a content part and returns ``(spk, content)``. Built on ``device``
(the CUDA card unless ``device="cpu"``; raises without a card), in eval
mode; ``pooling_params={"fused_inference": True}`` serves the statistics
pooling through its fused kernel.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn.loss import LOSSES, MARGIN_LOSSES, Scalar
from ..nn.tdnn import ReluBatchNormTdnnLayer
from ..parallel import comm
from .xvector import _check_position, _TwoEmbeddings, build_snowdar_trunk, snowdar_trunk


class MultiTaskXvector(_TwoEmbeddings):
    """Snowdar trunk; the speaker head (pooled) and 512-d frame phone
    features (multi_task_xvector_fix.py:101-214). The phone classifier
    lives in :class:`MultiTaskNet`, as the reference keeps it in the loss."""

    def __init__(self, input_dim: int = 80, num_frame_channels: int = 512, embd_dim: int = 512,
                 extend: bool = False, skip_connection: bool = False, se_block: bool = False, se_ratio: int = 4,
                 pooling: str = "statistics", pooling_params: Optional[dict] = None, momentum: float = 0.5,
                 bn_affine: bool = False, device: Any = None):
        super().__init__()
        c = self.num_frame_channels = num_frame_channels
        build_snowdar_trunk(self, input_dim, c, extend=extend, skip_connection=skip_connection, se_block=se_block,
                            se_ratio=se_ratio, momentum=momentum, bn_affine=bn_affine)
        for name in ("phonetic_tdnn5", "phonetic_tdnn6", "phonetic_tdnn7"):
            self.add_module(name, ReluBatchNormTdnnLayer(c, c, (0,), momentum, bn_affine=bn_affine))
        self.tdnn5 = ReluBatchNormTdnnLayer(c, 1500, (0,), momentum, bn_affine=bn_affine)
        self._build_head(1500, embd_dim, pooling, pooling_params, ("tdnn6", "tdnn7"), momentum=momentum,
                         use_scale=bn_affine, use_bias=bn_affine)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                position: str = "near") -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D], mask [B, T] -> (embedding at ``position``, phone
        features [B, T, C])."""
        _check_position(position)
        trunk = snowdar_trunk(self, x.transpose(1, 2), mask)
        ph = self.phonetic_tdnn7(self.phonetic_tdnn6(self.phonetic_tdnn5(trunk, mask), mask), mask)
        return self._head(self.tdnn5(trunk, mask), mask, position), ph.transpose(1, 2)


def phone_frame_loss(phone_logits: torch.Tensor, phone_targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     num_phones: Optional[int] = None) -> torch.Tensor:
    """Frame-level cross entropy of the phone head (reference
    SoftmaxLoss_frame_phone_fix, loss.py:133-160): labels outside
    [0, num_phones) count as 0; the mean over the frames ``mask`` keeps
    (over every frame without one)."""
    if num_phones is not None:
        bad = (phone_targets < 0) | (phone_targets >= num_phones)
        phone_targets = torch.where(bad, torch.zeros_like(phone_targets), phone_targets)
    logp = torch.log_softmax(phone_logits, dim=-1)
    nll = -logp.gather(-1, phone_targets[..., None].long())[..., 0]
    if mask is not None:
        m = mask.to(nll.dtype)
        return comm.batch_sum((nll * m).sum()) / torch.clamp_min(comm.batch_sum(m.sum()), 1.0)
    return nll.mean()


class MultiTaskNet(nn.Module):
    """MultiTaskXvector + the speaker head ``loss_spk`` + the frame phone
    classifier ``phone_affine``: the trainable unit, with SpeakerNet's
    interface. ``targets = {"spk": [B], "phone": [B, T]}``; the loss is
    loss_spk + mt_alpha * phone_frame_loss (multi_task_xvector_fix.py:230-243).
    Returns (loss, speaker logits, embeddings)."""

    def __init__(self, backbone: MultiTaskXvector, num_targets: int, num_phones: int,
                 loss_name: str = "margin_softmax", loss_params: Optional[dict] = None, mt_alpha: float = 0.1):
        super().__init__()
        self.backbone = backbone
        self.num_phones = num_phones
        self.mt_alpha = mt_alpha
        self._margin = loss_name in MARGIN_LOSSES
        self.loss_spk = LOSSES[loss_name](backbone.embd_dim, num_targets, **(loss_params or {}))
        self.phone_affine = nn.Linear(backbone.num_frame_channels, num_phones)
        self.to(next(backbone.parameters()).device)
        self.train(backbone.training)

    def forward(self, x: torch.Tensor, targets: dict, mask: Optional[torch.Tensor] = None, lambda_m: Scalar = 1.0,
                margin_offset: Scalar = 0.0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        emb, phone_feats = self.backbone(x, mask)
        margin = {"lambda_m": lambda_m, "margin_offset": margin_offset} if self._margin else {}
        loss_spk, logits = self.loss_spk(emb, targets["spk"], **margin)
        loss_phone = phone_frame_loss(self.phone_affine(phone_feats), targets["phone"], mask=mask,
                                      num_phones=self.num_phones)
        return loss_spk + self.mt_alpha * loss_phone, logits, emb

    def embed(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near") -> torch.Tensor:
        return self.backbone(x, mask, position=position)[0]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


class DALRegularizer(nn.Module):
    """The decoupling regularizer (DAL_regularizer,
    snowdar-xvector-FD-AL.py:62-76): bias-free projections ``w_noise`` of
    the content embedding and ``w_id`` of the speaker embedding, and the
    square of their mean cosine. train/fd.py trains the projections
    adversarially."""

    def __init__(self, dim: int):
        super().__init__()
        self.w_noise = nn.Linear(dim, dim, bias=False)
        self.w_id = nn.Linear(dim, dim, bias=False)

    def forward(self, content_emb: torch.Tensor, spk_emb: torch.Tensor) -> torch.Tensor:
        cos = comm.batch_mean((_unit(self.w_id(spk_emb)) * _unit(self.w_noise(content_emb))).sum(-1).mean())
        return cos ** 2


class FDXvector(_TwoEmbeddings):
    """The feature-decomposition x-vector (snowdar-xvector-FD-AL.py:79-292):
    the snowdar x-vector to tdnn7's BN, then an SE gate ``scale =
    sigmoid(att_fc2(relu(att_fc1(e))))`` splits the embedding into the
    content part ``e * scale`` and the speaker part ``e * (1 - scale)``.
    Returns (spk, content), both at the "near" position (JAX takes
    ``position`` and reads it nowhere)."""

    def __init__(self, input_dim: int = 80, num_frame_channels: int = 512, embd_dim: int = 512,
                 extend: bool = False, skip_connection: bool = False, se_block: bool = False, se_ratio: int = 4,
                 att_ratio: int = 8, pooling: str = "statistics", pooling_params: Optional[dict] = None,
                 momentum: float = 0.5, bn_affine: bool = False, device: Any = None):
        super().__init__()
        c = num_frame_channels
        build_snowdar_trunk(self, input_dim, c, extend=extend, skip_connection=skip_connection, se_block=se_block,
                            se_ratio=se_ratio, momentum=momentum, bn_affine=bn_affine)
        self.tdnn5 = ReluBatchNormTdnnLayer(c, 1500, (0,), momentum, bn_affine=bn_affine)
        self._build_head(1500, embd_dim, pooling, pooling_params, ("tdnn6", "tdnn7"), momentum=momentum,
                         use_scale=bn_affine, use_bias=bn_affine)
        self.att_fc1 = nn.Linear(embd_dim, embd_dim // att_ratio)
        self.att_fc2 = nn.Linear(embd_dim // att_ratio, embd_dim)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                position: str = "near") -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D], mask [B, T] -> (spk, content) [B, embd_dim] each."""
        _check_position(position)
        e = self._head(self.tdnn5(snowdar_trunk(self, x.transpose(1, 2), mask), mask), mask, "near")
        scale = torch.sigmoid(self.att_fc2(torch.relu(self.att_fc1(e))))
        return e * (1.0 - scale), e * scale


def fd_adversarial_loss(spk_emb: torch.Tensor, content_emb: torch.Tensor) -> torch.Tensor:
    """Mean squared cosine between the two embeddings."""
    return ((_unit(spk_emb) * _unit(content_emb)).sum(-1) ** 2).mean()
