"""ECAPA-TDNN x-vector (counterpart: asv_subtools_tpu/models/ecapa.py:26-379).

Emphasized Channel Attention, Propagation and Aggregation TDNN
(https://arxiv.org/abs/2005.07143) with the ECAPA attentive statistics
pooling, in eval mode (running statistics) and train mode
(``module.training``: masked batch statistics, dropout). Module and
parameter names follow the flax modules, so weights.py maps a JAX
variable tree onto this state_dict by rule.

Layout: the public input is channels-last ``[B, T, D]`` with a ``[B, T]``
mask (True = valid). The model transposes once to ``[B, C, T]``, the
layout of ``F.conv1d``, and holds it to the pooling, which receives a
``[B, T, C]`` view of that memory (no copy).

Padding semantics are the JAX model's: layers do not zero padded frames
between them; SEConnect, the attentive pooling, the BatchNorms of the
frame-level layers in train mode (and, before the model, CMVN) see the
mask. The pooled-level BatchNorms (``bn_stats``, ``fc1_bn``, ``fc2_bn``)
take no mask. The fused kernels serve inference only: with their flags
set, train mode still takes the unfused path, whose batch statistics
and gradients they do not compute.

``pooling`` picks the pooling: "ecpa-attentive" (the default, ECAPA's
attentive pooling) or any name of nn/pooling.py's zoo, built over the
MFA's width with ``pooling_params``; the zoo's ``mqmha`` with 2 queries
(ecapa_roadmap.yaml) pools to 6144 values at MFA 1536. As in both JAX
ECAPAs, only ``mqmha`` and ``mqmha-linear`` get the train flag: the
``xi`` pooling's BatchNorm (``lin1_relu_bn``) normalises with its
running statistics in train mode too and never updates them.

Convolutions, 1x1 products and the SE/BN/fc tail are plain PyTorch
(``F.conv1d``, ``torch.matmul``), as the JAX package leaves them to XLA.
In float32 on the card, PyTorch runs cuDNN convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True) and matrix products in full
float32 (``torch.backends.cuda.matmul.allow_tf32`` is False). A float32
comparison sets both to False, as chip_smoke.py does.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.dropout import dropout
from ..nn.fused_att_pooling import fused_attentive_stats_pool
from ..nn.fused_res2 import fused_res2_chain
from ..nn.norm import BatchNorm, LayerNorm
from ..nn.pooling import XiVectorPooling, build_pooling
from ..nn.tdnn import ReluBatchNormTdnnLayer


SCALE = 8  # Res2Net groups, ECAPA's


class Res2NetBlock(nn.Module):
    """Res2Net multi-scale conv block: group 0 passes through; group i+1
    is convolved (k=3, dilated) after adding the previous group's output.

    ``fused_inference=True`` runs the whole chain through the fused kernel
    (nn/fused_res2.py) in eval mode, with each stage's BN folded from its
    running statistics; the default, and train mode always, is the unfused
    path, one conv per stage.
    """

    def __init__(self, channels: int, dilation: int = 1, fused_inference: bool = False,
                 momentum: float = 0.5):
        super().__init__()
        self.dilation = dilation
        self.fused_inference = fused_inference
        if channels % SCALE:
            raise ValueError(f"channels ({channels}) must be a multiple of {SCALE}")
        hidden = channels // SCALE
        context = (-dilation, 0, dilation)
        self.blocks = [ReluBatchNormTdnnLayer(hidden, hidden, context, momentum) for _ in range(SCALE - 1)]
        for i, block in enumerate(self.blocks):
            self.add_module(f"block_{i}", block)

    def chain_args(self):
        """(w [stage, tap, in, out], b, bn_scale, bn_shift) of the fused
        chain: the seven convs' weights and each stage's BN folded from its
        running statistics."""
        convs = [blk.affine.conv for blk in self.blocks]
        folded = [blk.act_bn.bn.folded() for blk in self.blocks]
        return (torch.stack([c.weight.permute(2, 1, 0) for c in convs]),
                torch.stack([c.bias for c in convs]),
                torch.stack([s for s, _ in folded]), torch.stack([t for _, t in folded]))

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_res2_chain(x.transpose(1, 2), *self.chain_args(), dilation=self.dilation)
        return y.transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, T] -> [B, C, T]; the mask reaches the stages' BN."""
        if self.fused_inference and not self.training:
            return self._fused(x)
        parts = torch.chunk(x, SCALE, dim=1)
        outs = [parts[0]]
        sp = None
        for i, block in enumerate(self.blocks):
            sp = parts[i + 1] if i == 0 else sp + parts[i + 1]
            sp = block(sp, mask)
            outs.append(sp)
        return torch.cat(outs, dim=1)


class SEConnect(nn.Module):
    """Bottlenecked SE gate over the masked global time mean."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(channels, bottleneck)
        self.fc2 = nn.Linear(bottleneck, channels)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, T]; the gate reads the mean over valid frames, in x's type."""
        if mask is None:
            s = x.mean(dim=-1)
        else:
            m = mask.to(x.dtype)[:, None, :]
            s = (x * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)
        s = torch.relu(self.fc1(s))
        s = torch.sigmoid(self.fc2(s))
        return x * s[..., None]


class SERes2Block(nn.Module):
    """1x1 conv -> Res2Net -> 1x1 conv -> SE, with residual (in = out
    channels, as in every ECAPA block)."""

    def __init__(self, channels: int, dilation: int = 1, momentum: float = 0.5):
        super().__init__()
        self.conv1 = ReluBatchNormTdnnLayer(channels, channels, momentum=momentum)
        self.res2net = Res2NetBlock(channels, dilation=dilation, momentum=momentum)
        self.conv2 = ReluBatchNormTdnnLayer(channels, channels, momentum=momentum)
        self.se = SEConnect(channels)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.conv2(self.res2net(self.conv1(x, mask), mask), mask)
        return self.se(y, mask) + x


class _SplitGlobalConv(nn.Module):
    """1x1 conv over [x; mean; std] without building the concatenation.

    Owns ``kernel [1, 3C, F]`` and ``bias [F]``, the flax layout of a conv
    over the concatenation. y = Wx^T x + (mean @ Wm + std @ Ws + b).
    """

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(1, 3 * in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.normal_(self.kernel, std=(3 * in_channels) ** -0.5)

    def forward(self, x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
        """x [B, C, T], mean/std [B, C] -> [B, F, T]."""
        d = x.shape[1]
        k = self.kernel[0]
        glob = mean @ k[d:2 * d] + std @ k[2 * d:] + self.bias
        return torch.matmul(k[:d].t(), x) + glob[..., None]


class EcapaAttentiveStatsPool(nn.Module):
    """ECAPA channel-wise attentive statistics pooling.

    x [B, T, C] -> [B, 2C]. With ``time_attention`` (ECAPA's) the attention
    reads [x; mean; std] through ``att1``, a split 1x1 conv; without it
    (the Conformer's) ``att1`` is a plain 1x1 conv over x. ``norm_type``
    "batch_norm" (``att_bn``) or "layer_norm" (``att_norm``, the
    Conformer's). ``fused_inference=True`` runs the whole pooling through
    the fused kernel (nn/fused_att_pooling.py) in eval mode, with time
    attention and BatchNorm only, as the JAX module's ``fused_inference``
    branch does; otherwise, and in train mode always, the unfused path
    runs. ``att_bn`` keeps torch's default momentum 0.1: the reference
    builds this BN without the model's bn_params (JAX
    models/ecapa.py:339-343).
    """

    def __init__(self, channels: int, bottleneck: int = 128, fused_inference: bool = False,
                 time_attention: bool = True, norm_type: str = "batch_norm"):
        super().__init__()
        if norm_type not in ("batch_norm", "layer_norm"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.fused_inference, self.time_attention, self.norm_type = fused_inference, time_attention, norm_type
        self.att1 = _SplitGlobalConv(channels, bottleneck) if time_attention else nn.Conv1d(channels, bottleneck, 1)
        if norm_type == "batch_norm":
            self.att_bn = BatchNorm(bottleneck, momentum=0.1)
        else:
            self.att_norm = LayerNorm(bottleneck)
        self.att2 = nn.Conv1d(bottleneck, channels, 1)

    def _fused(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        d = x.shape[-1]
        k = self.att1.kernel[0]  # [3C, K]
        bn_s, bn_t = self.att_bn.folded()
        return fused_attentive_stats_pool(
            x, k[:d], k[d:2 * d], k[2 * d:], self.att1.bias, bn_s, bn_t,
            self.att2.weight[..., 0].t(), self.att2.bias, mask=mask,
        ).to(x.dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (self.fused_inference and not self.training and self.time_attention
                and self.norm_type == "batch_norm"):
            return self._fused(x, mask)
        xc = x.transpose(1, 2)  # [B, C, T]
        if self.time_attention:
            # global std uses the unbiased variance (ddof=1), the reference's
            # torch.var default
            if mask is not None:
                m = mask.to(x.dtype)[:, None, :]
                count = torch.clamp_min(m.sum(-1, keepdim=True), 1.0)
                mean = (xc * m).sum(-1, keepdim=True) / count
                var = ((xc - mean) ** 2 * m).sum(-1, keepdim=True) / torch.clamp_min(count - 1.0, 1.0)
            else:
                mean = xc.mean(-1, keepdim=True)
                var = xc.var(-1, keepdim=True, unbiased=True)
            std = torch.sqrt(var + 1e-5)
            a = torch.relu(self.att1(xc, mean[..., 0], std[..., 0]))
        else:
            a = torch.relu(self.att1(xc))
        if self.norm_type == "batch_norm":
            a = self.att_bn(a, mask)
        else:
            a = self.att_norm(a.transpose(1, 2)).transpose(1, 2)
        a = self.att2(torch.tanh(a))  # [B, C, T] per-channel time logits
        if mask is not None:
            a = a.masked_fill(~mask[:, None, :], float("-inf"))
        alpha = torch.softmax(a, dim=-1)
        # the weighted sums go to at least float32, as the fused kernel's
        # do: in bfloat16, E[x^2] - mean^2 cancels (it cost the bf16
        # Conformer 5e-4 of cosine against its f32 model)
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = (alpha * xc).sum(-1, dtype=acc)
        var = (alpha * xc * xc).sum(-1, dtype=acc) - mean ** 2
        std = torch.sqrt(torch.clamp_min(var, 1e-5))
        return torch.cat([mean, std], dim=-1).to(x.dtype)


class EcapaTdnn(nn.Module):
    """ECAPA-TDNN backbone -> speaker embedding. C1024 is ``channels=1024``,
    the voxceleb recipe's. ``position`` picks the output: "near" (fc2
    affine, relu, BN; the default), "near_affine" (fc2 affine) or "far"
    (fc1 affine, with ``fc1=True``).

    ``pooling`` and ``pooling_params``: "ecpa-attentive" reads
    ``hidden_size`` (128) and ``time_attention`` (True) from the params,
    and its BatchNorm keeps momentum 0.1 whatever the model's; another
    name builds that pooling of the zoo (nn/pooling.py) with the params.

    Built on ``device`` (the CUDA card unless ``device="cpu"``; raises
    without a card), in eval mode. Cast with ``.to(torch.bfloat16)`` for
    serving; training runs it in train mode with a cast copy of f32 master
    weights (train/trainer.py).
    """

    def __init__(
        self,
        input_dim: int = 80,
        channels: int = 1024,
        embd_dim: int = 192,
        mfa_conv: int = 1536,
        pooling: str = "ecpa-attentive",
        pooling_params: Optional[dict] = None,
        fc1: bool = False,
        momentum: float = 0.5,
        aug_dropout: float = 0.0,
        tail_dropout: float = 0.0,
        device: Any = None,
    ):
        super().__init__()
        c = channels
        self.embd_dim, self.aug_dropout, self.tail_dropout = embd_dim, aug_dropout, tail_dropout
        self.layer1 = ReluBatchNormTdnnLayer(input_dim, c, context=(-2, -1, 0, 1, 2), momentum=momentum)
        self.layer2 = SERes2Block(c, dilation=2, momentum=momentum)
        self.layer3 = SERes2Block(c, dilation=3, momentum=momentum)
        self.layer4 = SERes2Block(c, dilation=4, momentum=momentum)
        self.mfa = ReluBatchNormTdnnLayer(3 * c, mfa_conv, momentum=momentum)
        pp = dict(pooling_params or {})
        if pooling == "ecpa-attentive":
            self.stats = EcapaAttentiveStatsPool(mfa_conv, bottleneck=pp.get("hidden_size", 128),
                                                 time_attention=pp.get("time_attention", True))
            stats_dim = 2 * mfa_conv
        else:
            self.stats = build_pooling(pooling, mfa_conv, pp)
            stats_dim = self.stats.output_dim(mfa_conv)
        self.bn_stats = BatchNorm(stats_dim, momentum=momentum)
        fc2_in = stats_dim
        if fc1:
            self.fc1_affine = nn.Linear(stats_dim, embd_dim)
            self.fc1_bn = BatchNorm(embd_dim, momentum=momentum)
            fc2_in = embd_dim
        self.fc1 = fc1
        self.fc2_affine = nn.Linear(fc2_in, embd_dim)
        self.fc2_bn = BatchNorm(embd_dim, momentum=momentum)
        self.eval()
        self.to(resolve_device(device))

    def train(self, mode: bool = True) -> "EcapaTdnn":
        return keep_xi_bn_in_eval(super().train(mode))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, D] (channels-last), mask [B, T] -> embedding [B, embd_dim].
        ``generator`` draws the dropout masks in train mode."""
        if self.aug_dropout > 0 and self.training:
            x = dropout(x, self.aug_dropout, generator)
        h = self.layer1(x.transpose(1, 2), mask)
        x1 = self.layer2(h, mask)
        x2 = self.layer3(h + x1, mask)
        x3 = self.layer4(h + x1 + x2, mask)
        y = self.mfa(torch.cat([x1, x2, x3], dim=1), mask)
        h = self.bn_stats(self.stats(y.transpose(1, 2), mask))
        if self.fc1:
            z1 = self.fc1_affine(h)
            if position == "far":
                return z1
            h = self.fc1_bn(F.relu(z1))
        elif position == "far":
            raise ValueError("position='far' requires fc1=True")
        z = self.fc2_affine(h)
        if position == "near_affine":
            return z
        z = self.fc2_bn(F.relu(z))
        if self.tail_dropout > 0 and self.training:
            z = dropout(z, self.tail_dropout, generator)
        return z


def keep_xi_bn_in_eval(model: nn.Module) -> nn.Module:
    """An ECAPA's ``xi`` pooling keeps its BatchNorm in eval mode: the JAX
    ECAPAs hand the train flag to no pooling but mqmha and mqmha-linear,
    and the xi pooling's flag defaults to False."""
    if isinstance(model.stats, XiVectorPooling):
        model.stats.lin1_relu_bn.train(False)
    return model
