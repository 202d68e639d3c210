"""ECAPA-TDNN, lawlict variant (counterpart: asv_subtools_tpu/models/ecapa_lawlict.py).

The reference's second ECAPA (after github.com/lawlict/ECAPA-TDNN). Where
it differs from models/ecapa.py's EcapaTdnn:

* the Res2 chain (:class:`LawlictRes2Block`) convolves the first split
  and passes the last one through; its convs have no bias and run
  conv -> relu -> BN at momentum 0.1;
* the SE gate (:class:`SEConnectLinear`) is two Linears with a
  ``channels // 4`` bottleneck over the masked time mean;
* the MFA keeps its width (3C) and has a bias;
* the pooling (:class:`LawlictAttentiveStatsPool`) is a tanh bottleneck
  without global context, ``std = sqrt(max(var, 1e-9))``;
* ``bn_stats`` runs at momentum 0.1, ``fc1_bn`` and ``fc2_bn`` at
  ``fc_momentum`` (0.5); every other BN at 0.1.

Layout and mask semantics are models/ecapa.py's: ``[B, C, T]`` inside,
a ``[B, T, C]`` view handed to the pooling, the frame-level BNs masked in
train mode, the pooled-level ones not. No kernel serves this chain.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.dropout import dropout
from ..nn.norm import BatchNorm
from ..nn.pooling import build_pooling
from ..nn.tdnn import ReluBatchNormTdnnLayer
from .ecapa import keep_xi_bn_in_eval

SCALE = 8


def _masked_time_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, C, T] -> the mean over valid frames [B, C], in x's type."""
    if mask is None:
        return x.mean(dim=-1)
    m = mask.to(x.dtype)[:, None, :]
    return (x * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)


class LawlictRes2Block(nn.Module):
    """Res2Conv1dReluBn: splits 0..6 are convolved hierarchically (split
    i's input adds split i-1's output), split 7 passes through and is
    appended last."""

    def __init__(self, channels: int, dilation: int = 1, kernel_size: int = 3):
        super().__init__()
        if channels % SCALE:
            raise ValueError(f"channels ({channels}) must be a multiple of {SCALE}")
        width, half = channels // SCALE, kernel_size // 2
        context = tuple(range(-half * dilation, half * dilation + 1, dilation))
        for i in range(SCALE - 1):
            self.add_module(f"block_{i}", ReluBatchNormTdnnLayer(width, width, context, 0.1, use_bias=False))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        parts = torch.chunk(x, SCALE, dim=1)
        outs, sp = [], None
        for i in range(SCALE - 1):
            sp = parts[i] if i == 0 else sp + parts[i]
            sp = getattr(self, f"block_{i}")(sp, mask)
            outs.append(sp)
        outs.append(parts[-1])
        return torch.cat(outs, dim=1)


class SEConnectLinear(nn.Module):
    """SE gate: ``linear1`` (C -> C / s), relu, ``linear2``, sigmoid, over
    the masked time mean."""

    def __init__(self, channels: int, s: int = 4):
        super().__init__()
        if channels % s:
            raise ValueError(f"channels {channels} % s {s} != 0")
        self.linear1 = nn.Linear(channels, channels // s)
        self.linear2 = nn.Linear(channels // s, channels)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        g = torch.sigmoid(self.linear2(torch.relu(self.linear1(_masked_time_mean(x, mask)))))
        return x * g[..., None]


class LawlictSERes2Block(nn.Module):
    """1x1 conv -> LawlictRes2Block -> 1x1 conv -> SE, plus the input
    (the model-level residual folded into the block, as in JAX)."""

    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.conv1 = ReluBatchNormTdnnLayer(channels, channels, momentum=0.1, use_bias=False)
        self.res2net = LawlictRes2Block(channels, dilation)
        self.conv2 = ReluBatchNormTdnnLayer(channels, channels, momentum=0.1, use_bias=False)
        self.se = SEConnectLinear(channels)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.conv2(self.res2net(self.conv1(x, mask), mask), mask)
        return self.se(y, mask) + x


class LawlictAttentiveStatsPool(nn.Module):
    """alpha = softmax_T(linear2(tanh(linear1(x)))), per channel; weighted
    mean and std (``sqrt(max(var, 1e-9))``). x [B, T, C] -> [B, 2C]. The
    weighted sums run in at least float32 and the result is cast back to
    x's type: in bfloat16, E[x^2] - mean^2 cancels."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.linear1 = nn.Conv1d(channels, bottleneck, 1)
        self.linear2 = nn.Conv1d(bottleneck, channels, 1)

    def output_dim(self, input_dim: int) -> int:
        return 2 * input_dim

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xc = x.transpose(1, 2)  # [B, C, T]
        a = self.linear2(torch.tanh(self.linear1(xc)))
        if mask is not None:
            a = a.masked_fill(~mask[:, None, :], float("-inf"))
        alpha = torch.softmax(a, dim=-1)
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = (alpha * xc).sum(-1, dtype=acc)
        var = (alpha * xc * xc).sum(-1, dtype=acc) - mean ** 2
        std = torch.sqrt(torch.clamp_min(var, 1e-9))
        return torch.cat([mean, std], dim=-1).to(x.dtype)


class EcapaLawlict(nn.Module):
    """lawlict ECAPA-TDNN backbone -> speaker embedding (C512 by default,
    ecapa_lawlict.yaml's). ``position``: "near" (fc2 affine, relu, BN; the
    default), "near_affine" (fc2 affine) or "far" (fc1 affine, with
    ``fc1=True``). ``pooling`` "ecpa-attentive" is
    :class:`LawlictAttentiveStatsPool` (``hidden_size`` from
    ``pooling_params``); another name builds that pooling of the zoo, with
    models/ecapa.py's train-flag rule for ``xi``.

    Built on ``device`` (the CUDA card unless ``device="cpu"``; raises
    without a card), in eval mode. ``generator`` draws the dropout masks in
    train mode.
    """

    def __init__(
        self,
        input_dim: int = 80,
        channels: int = 512,
        embd_dim: int = 192,
        pooling: str = "ecpa-attentive",
        pooling_params: Optional[dict] = None,
        fc1: bool = False,
        fc_momentum: float = 0.5,
        aug_dropout: float = 0.0,
        tail_dropout: float = 0.0,
        device: Any = None,
    ):
        super().__init__()
        c = channels
        self.embd_dim, self.aug_dropout, self.tail_dropout, self.fc1 = embd_dim, aug_dropout, tail_dropout, fc1
        self.layer1 = ReluBatchNormTdnnLayer(input_dim, c, (-2, -1, 0, 1, 2), 0.1, use_bias=False)
        self.layer2 = LawlictSERes2Block(c, dilation=2)
        self.layer3 = LawlictSERes2Block(c, dilation=3)
        self.layer4 = LawlictSERes2Block(c, dilation=4)
        self.mfa = ReluBatchNormTdnnLayer(3 * c, 3 * c, momentum=0.1)
        pp = dict(pooling_params or {})
        if pooling == "ecpa-attentive":
            self.stats = LawlictAttentiveStatsPool(3 * c, pp.get("hidden_size", 128))
        else:
            self.stats = build_pooling(pooling, 3 * c, pp)
        stats_dim = self.stats.output_dim(3 * c)
        self.bn_stats = BatchNorm(stats_dim, momentum=0.1)
        fc2_in = stats_dim
        if fc1:
            self.fc1_affine = nn.Linear(stats_dim, embd_dim)
            self.fc1_bn = BatchNorm(embd_dim, momentum=fc_momentum)
            fc2_in = embd_dim
        self.fc2_affine = nn.Linear(fc2_in, embd_dim)
        self.fc2_bn = BatchNorm(embd_dim, momentum=fc_momentum)
        self.eval()
        self.to(resolve_device(device))

    def train(self, mode: bool = True) -> "EcapaLawlict":
        return keep_xi_bn_in_eval(super().train(mode))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, D] (channels-last), mask [B, T] -> embedding [B, embd_dim]."""
        if self.aug_dropout > 0 and self.training:
            x = dropout(x, self.aug_dropout, generator)
        h = self.layer1(x.transpose(1, 2), mask)
        o2 = self.layer2(h, mask)
        o3 = self.layer3(h + o2, mask)
        o4 = self.layer4(h + o2 + o3, mask)
        y = self.mfa(torch.cat([o2, o3, o4], dim=1), mask)
        hv = self.bn_stats(self.stats(y.transpose(1, 2), mask))
        if self.fc1:
            z1 = self.fc1_affine(hv)
            if position == "far":
                return z1
            hv = self.fc1_bn(F.relu(z1))
        elif position == "far":
            raise ValueError("position='far' requires fc1=True")
        z = self.fc2_affine(hv)
        if position == "near_affine":
            return z
        z = self.fc2_bn(F.relu(z))
        if self.tail_dropout > 0 and self.training:
            z = dropout(z, self.tail_dropout, generator)
        return z
