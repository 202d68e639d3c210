"""Temporal poolings (counterpart: asv_subtools_tpu/nn/pooling.py).

Every pooling maps frame-level features ``[B, T, D]`` (channels-last; a
transposed view of the TDNN's ``[B, D, T]`` is taken as it is) to a fixed
vector. ``mask [B, T]`` (True = valid) makes padded batches exact: masked
frames go to -inf before each softmax over time. Each class takes the
input width ``input_dim`` (the learnable ones build their layers from it)
and names its output width with ``output_dim(input_dim)``;
:func:`build_pooling` builds one by name. The attention layers run on the
``[B, D, T]`` layout of ``TdnnAffine``. Train mode is the module's
(``module.training``): the BatchNorm inside ``mqmha`` and ``xi`` then uses
the masked batch statistics.

The weighted statistics of the attentive poolings, xi and LDE run in at
least float32, products and sums, and their result is cast back to x's
type: in bfloat16, E[x^2] - mean^2 cancels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .fused_stats_pooling import fused_stats_pooling
from .norm import BatchNorm
from .tdnn import ReluBatchNormTdnnLayer, TdnnAffine

_EPS = 1.0e-10


def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _masked_moments(x: torch.Tensor, mask: Optional[torch.Tensor], unbiased: bool = False,
                    eps: float = _EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean and std over time, two-pass, in x's type.
    x [B, T, D], mask [B, T] or None. Without a mask the count is a Python
    number: a tensor made from it on the card would be a blocking copy."""
    if mask is None:
        count = float(x.shape[-2])
        mean = x.mean(dim=-2)
        var_num = ((x - mean[..., None, :]) ** 2).sum(dim=-2)
        denom = max(count - 1.0, 1.0) if unbiased else count
    else:
        m = mask.to(x.dtype)[..., None]
        count = torch.clamp_min(m.sum(dim=-2), 1.0)
        mean = (x * m).sum(dim=-2) / count
        var_num = (((x - mean[..., None, :]) ** 2) * m).sum(dim=-2)
        denom = torch.clamp_min(count - 1.0, 1.0) if unbiased else count
    std = torch.sqrt(torch.clamp_min(var_num / denom, eps))
    return mean, std


def _masked_logits(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """logits [B, K, T]: masked frames to -inf (the softmax runs over T)."""
    return logits if mask is None else logits.masked_fill(~mask[:, None, :], float("-inf"))


class StatisticsPooling(nn.Module):
    """Mean [+ stddev] pooling. ``fused_inference=True`` runs the pooling
    through the fused kernel (nn/fused_stats_pooling.py) in eval mode; the
    kernel computes the biased std with the mean, so it takes
    ``stddev=True, unbiased=False`` only. The default, and train mode
    always, is the unfused two-pass path: the kernel has no backward."""

    def __init__(self, stddev: bool = True, unbiased: bool = False, eps: float = _EPS,
                 fused_inference: bool = False, input_dim: Optional[int] = None):
        super().__init__()
        if fused_inference and (not stddev or unbiased):
            raise ValueError("the fused statistics pooling computes mean ++ biased std only "
                             "(stddev=True, unbiased=False)")
        self.stddev, self.unbiased, self.eps = stddev, unbiased, eps
        self.fused_inference = fused_inference

    def output_dim(self, input_dim: int) -> int:
        return input_dim * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fused_inference and not self.training:
            return fused_stats_pooling(x, mask, eps=self.eps).to(x.dtype)
        mean, std = _masked_moments(x, mask, unbiased=self.unbiased, eps=self.eps)
        return torch.cat([mean, std], dim=-1) if self.stddev else mean


class FreeStatisticsPooling(nn.Module):
    """Statistics over all frames: any mask is ignored, so padded frames
    enter the mean and std. Only for parity with reference models evaluated
    on padded batches; the masked variant is the default."""

    def __init__(self, stddev: bool = True, unbiased: bool = False, eps: float = _EPS,
                 input_dim: Optional[int] = None):
        super().__init__()
        self.stddev, self.unbiased, self.eps = stddev, unbiased, eps

    def output_dim(self, input_dim: int) -> int:
        return input_dim * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mean, std = _masked_moments(x, None, unbiased=self.unbiased, eps=self.eps)
        return torch.cat([mean, std], dim=-1) if self.stddev else mean


class LDEPooling(nn.Module):
    """Learnable dictionary encoding: ``mu [D, c_num]`` and ``s [c_num]``;
    each frame's residuals to the c_num centres, weighted by a softmax over
    the centres, averaged over valid frames. Output ``[B, D * c_num]``."""

    def __init__(self, input_dim: int, c_num: int = 64, eps: float = _EPS):
        super().__init__()
        self.c_num, self.eps = c_num, eps
        self.mu = nn.Parameter(torch.randn(input_dim, c_num))
        self.s = nn.Parameter(torch.ones(c_num))

    def output_dim(self, input_dim: int) -> int:
        return input_dim * self.c_num

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        acc = _acc(x)
        r = x.to(acc)[..., None] - self.mu.to(acc)  # [B, T, D, C]
        dist = (r * r).sum(dim=-2, keepdim=True)
        w = torch.softmax(-(self.s.to(acc) ** 2 + self.eps) * dist, dim=-1)
        if mask is None:
            e = (w * r).mean(dim=-3)
        else:
            m = mask.to(acc)[..., None, None]
            e = (w * r * m).sum(dim=-3) / torch.clamp_min(m.sum(dim=-3), 1.0)
        return e.reshape(e.shape[0], -1).to(x.dtype)


class XiVectorPooling(nn.Module):
    """Xi-vector Gaussian-posterior pooling: ``lin1_relu_bn`` and ``lin2``
    predict per-frame log-precisions; the pooled vector is the posterior
    mean given the prior (``prior_mean``, ``prior_logprec``), a softmax
    over the frames and the prior as one more frame."""

    def __init__(self, input_dim: int, hidden_size: int = 256, stddev: bool = False, train_mean: bool = True,
                 train_prec: bool = True):
        super().__init__()
        self.stddev, self.train_mean, self.train_prec = stddev, train_mean, train_prec
        self.prior_mean = nn.Parameter(torch.zeros(input_dim))
        self.prior_logprec = nn.Parameter(torch.zeros(input_dim))
        self.lin1_relu_bn = ReluBatchNormTdnnLayer(input_dim, hidden_size)
        self.lin2 = TdnnAffine(hidden_size, input_dim)

    def output_dim(self, input_dim: int) -> int:
        return input_dim * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, d = x.shape
        pm = self.prior_mean if self.train_mean else self.prior_mean.detach()
        pl = self.prior_logprec if self.train_prec else self.prior_logprec.detach()
        logprec = self.lin2(self.lin1_relu_bn(x.transpose(1, 2), mask))  # [B, D, T]
        logprec = 2.0 * torch.log(F.softplus(logprec) + _EPS)
        acc = _acc(x)
        feats = torch.cat([x.transpose(1, 2), pm.to(x.dtype)[None, :, None].expand(b, d, 1)], dim=-1).to(acc)
        precs = torch.cat([logprec, pl.to(logprec.dtype)[None, :, None].expand(b, d, 1)], dim=-1)
        if mask is not None:
            mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=-1)
        attn = torch.softmax(_masked_logits(precs, mask).to(acc), dim=-1)
        phi = (feats * attn).sum(-1)
        if self.stddev:
            sigma = torch.sqrt(torch.clamp_min((feats * feats * attn).sum(-1) - phi * phi, _EPS))
            return torch.cat([phi, sigma], dim=-1).to(x.dtype)
        return phi.to(x.dtype)


class AttentionAlphaComponent(nn.Module):
    """Frame weights alpha = softmax_T(v' f(W x + b) [/ t]): multi-head,
    split or global input, shared or per-channel weights, one or two
    affine layers (``first_affine``, ``last_affine``), fixed or learnable
    (``t``) per-head temperatures. x [B, D, T] -> alpha [B, K, T] with
    K = num_head * final_dim."""

    def __init__(self, input_dim: int, num_head: int = 1, split_input: bool = True, share: bool = True,
                 affine_layers: int = 2, hidden_size: int = 64, context: Sequence[int] = (0,),
                 use_bias: bool = True, temperature: bool = False, fixed: bool = True):
        super().__init__()
        if num_head > 1 and split_input and input_dim % num_head:
            raise ValueError("input_dim must divide num_head when split_input")
        if share:
            final_dim = 1
        elif split_input:
            final_dim = input_dim // num_head
        else:
            final_dim = input_dim
        self.num_head = num_head
        first_groups, last_groups = 1, 1
        if affine_layers == 2:
            hidden = hidden_size * num_head
            if num_head > 1:
                last_groups = num_head
                if split_input:
                    first_groups = num_head
            self.first_affine = TdnnAffine(input_dim, hidden, context, use_bias=use_bias, groups=first_groups)
            last_in = hidden
        elif affine_layers == 1:
            if num_head > 1 and split_input:
                last_groups = num_head
            self.first_affine = None
            last_in = input_dim
        else:
            raise ValueError("affine_layers must be 1 or 2")
        self.last_affine = TdnnAffine(last_in, final_dim * num_head, context, use_bias=use_bias, groups=last_groups)
        self.temperature = num_head > 1 and temperature
        self.fixed = fixed
        if self.temperature and not fixed:
            self.t = nn.Parameter(torch.zeros(num_head))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x if self.first_affine is None else torch.relu(self.first_affine(x))
        logits = self.last_affine(h)  # [B, H*final, T]
        if self.temperature:
            if self.fixed:
                # max(1, (i // 2) * 5) for head i, made on the device: a
                # tensor from a host list would be a blocking copy
                i = torch.arange(self.num_head, device=logits.device)
                t = torch.clamp_min(torch.div(i, 2, rounding_mode="floor") * 5.0, 1.0).to(logits.dtype)
            else:
                t = 1.0 + self.t ** 2
            b, k, tlen = logits.shape
            logits = (logits.reshape(b, self.num_head, -1, tlen) / t[:, None, None]).reshape(b, k, tlen)
        return torch.softmax(_masked_logits(logits, mask), dim=-1)


def _attn_stats(x_heads: torch.Tensor, alpha_heads: torch.Tensor, stddev: bool, stddev_attention: bool,
                mask: Optional[torch.Tensor]):
    """Weighted statistics over time, in at least f32. x_heads and
    alpha_heads [B, T, H, D_h] (alpha may broadcast on the last two)."""
    acc = _acc(x_heads)
    x_heads, alpha_heads = x_heads.to(acc), alpha_heads.to(acc)
    mean = (alpha_heads * x_heads).sum(dim=-3)  # [B, H, D_h]
    if not stddev:
        return mean
    if stddev_attention:
        var = (alpha_heads * x_heads * x_heads).sum(dim=-3) - mean * mean
    else:
        diff = x_heads - mean[..., None, :, :]
        if mask is None:
            var = (diff * diff).mean(dim=-3)
        else:
            m = mask[..., None, None].to(acc)
            var = (diff * diff * m).sum(dim=-3) / torch.clamp_min(m.sum(dim=-3), 1.0)
    return mean, torch.sqrt(torch.clamp_min(var, _EPS))


class AttentiveStatisticsPooling(nn.Module):
    """Single-head attentive statistics pooling (``attention``)."""

    def __init__(self, input_dim: int, affine_layers: int = 2, hidden_size: int = 64, context: Sequence[int] = (0,),
                 stddev: bool = True, stddev_attention: bool = True):
        super().__init__()
        self.stddev, self.stddev_attention = stddev, stddev_attention
        self.attention = AttentionAlphaComponent(input_dim, num_head=1, share=True, affine_layers=affine_layers,
                                                 hidden_size=hidden_size, context=context)

    def output_dim(self, input_dim: int) -> int:
        return input_dim * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        alpha = self.attention(x.transpose(1, 2), mask).transpose(1, 2)  # [B, T, 1]
        out = _attn_stats(x[..., None, :], alpha[..., None, :], self.stddev, self.stddev_attention, mask)
        if self.stddev:
            return torch.cat([out[0][:, 0], out[1][:, 0]], dim=-1).to(x.dtype)
        return out[:, 0].to(x.dtype)


class MultiHeadAttentionPooling(nn.Module):
    """Split-input multi-head attentive statistics: the heads partition the
    feature dim. Output ``[B, 2 D]`` (stddev)."""

    def __init__(self, input_dim: int, num_head: int = 4, stddev: bool = True, stddev_attention: bool = True,
                 share: bool = True, affine_layers: int = 1, hidden_size: int = 64, temperature: bool = False,
                 fixed: bool = True):
        super().__init__()
        self.num_head, self.stddev, self.stddev_attention = num_head, stddev, stddev_attention
        self.attention = AttentionAlphaComponent(input_dim, num_head=num_head, split_input=True, share=share,
                                                 affine_layers=affine_layers, hidden_size=hidden_size,
                                                 use_bias=False, temperature=temperature, fixed=fixed)

    def output_dim(self, input_dim: int) -> int:
        return input_dim * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_head
        alpha = self.attention(x.transpose(1, 2), mask).transpose(1, 2).reshape(b, t, h, -1)
        out = _attn_stats(x.reshape(b, t, h, d // h), alpha, self.stddev, self.stddev_attention, mask)
        if self.stddev:
            return torch.cat([out[0].reshape(b, d), out[1].reshape(b, d)], dim=-1).to(x.dtype)
        return out.reshape(b, d).to(x.dtype)


class GlobalMultiHeadAttentionPooling(nn.Module):
    """Global multi-head attentive statistics: each head sees every
    feature. Output ``[B, 2 D num_head]`` (stddev)."""

    def __init__(self, input_dim: int, num_head: int = 4, stddev: bool = True, stddev_attention: bool = True,
                 share: bool = True, affine_layers: int = 2, hidden_size: int = 64, temperature: bool = False,
                 fixed: bool = True):
        super().__init__()
        self.num_head, self.stddev, self.stddev_attention = num_head, stddev, stddev_attention
        self.attention = AttentionAlphaComponent(input_dim, num_head=num_head, split_input=False, share=share,
                                                 affine_layers=affine_layers, hidden_size=hidden_size,
                                                 use_bias=True, temperature=temperature, fixed=fixed)

    def output_dim(self, input_dim: int) -> int:
        return input_dim * self.num_head * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_head
        alpha = self.attention(x.transpose(1, 2), mask).transpose(1, 2).reshape(b, t, h, -1)
        out = _attn_stats(x[..., None, :], alpha, self.stddev, self.stddev_attention, mask)
        if self.stddev:
            return torch.cat([out[0].reshape(b, h * d), out[1].reshape(b, h * d)], dim=-1).to(x.dtype)
        return out.reshape(b, h * d).to(x.dtype)


class MultiResolutionMultiHeadAttentionPooling(GlobalMultiHeadAttentionPooling):
    """Global multi-head attention with fixed per-head temperatures."""

    def __init__(self, *args, temperature: bool = True, **kwargs):
        super().__init__(*args, temperature=temperature, **kwargs)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over [B, C, T] (epsilon 1e-6, statistics over
    each group's channels and every frame, padded ones included), with
    flax's parameter names; in at least float32, cast back."""

    def __init__(self, num_groups: int, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = _acc(x)
        y = F.group_norm(x.to(acc), self.num_groups, self.scale.to(acc), self.bias.to(acc), self.epsilon)
        return y.to(x.dtype)


class MQMHASP(nn.Module):
    """Multi-query multi-head attentive statistics pooling
    (https://arxiv.org/pdf/2110.05042.pdf): ``att1`` (grouped by head),
    relu, ``att_norm`` (BatchNorm, or GroupNorm for "layer_norm"), tanh,
    ``att2`` (grouped by head and query); with ``affine_layers=1``,
    ``att1`` gives the logits. Output ``[B, 2 D num_q]`` (stddev)."""

    def __init__(self, input_dim: int, num_q: int = 2, num_head: int = 4, hidden_size: int = 128,
                 stddev: bool = True, share: bool = True, affine_layers: int = 2, time_attention: bool = False,
                 norm_type: str = "batch_norm"):
        super().__init__()
        h, q = max(1, num_head), max(1, num_q)
        d = input_dim
        if d % h:
            raise ValueError("in_dim must be divisible by num_head")
        self.h, self.q, self.stddev, self.time_attention = h, q, stddev, time_attention
        in_att = d * ((3 if stddev else 2) if time_attention else 1)
        att_odim = 1 if share else d // h
        self.affine_layers = affine_layers
        if affine_layers == 2:
            hidd = hidden_size * h * q
            self.att1 = TdnnAffine(in_att, hidd, groups=h)
            if norm_type == "batch_norm":
                self.att_norm = BatchNorm(hidd)
            elif norm_type == "layer_norm":
                self.att_norm = GroupNorm(h * q, hidd)
            else:
                raise ValueError(f"Unsupported norm type {norm_type}")
            self.norm_type = norm_type
            self.att2 = TdnnAffine(hidd, att_odim * h * q, groups=h * q)
        elif affine_layers == 1:
            self.att1 = TdnnAffine(in_att, att_odim * h * q, groups=h)
        else:
            raise ValueError("affine_layers must be 1 or 2")

    def output_dim(self, input_dim: int) -> int:
        return input_dim * self.q * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h, q = self.h, self.q
        if self.time_attention:
            mean, std = _masked_moments(x, mask)
            reps = [x, mean[:, None, :].expand(b, t, d)]
            if self.stddev:
                reps.append(std[:, None, :].expand(b, t, d))
            x_in = torch.cat([r.reshape(b, t, h, d // h) for r in reps], dim=-1).reshape(b, t, -1)
        else:
            x_in = x
        y = self.att1(x_in.transpose(1, 2))
        if self.affine_layers == 2:
            y = torch.relu(y)
            y = self.att_norm(y, mask) if self.norm_type == "batch_norm" else self.att_norm(y)
            y = self.att2(torch.tanh(y))
        alpha = torch.softmax(_masked_logits(y, mask), dim=-1)  # [B, H*Q*att_odim, T]
        acc = _acc(x)
        alpha = alpha.transpose(1, 2).reshape(b, t, h, q, -1).to(acc)
        x_h = x.reshape(b, t, h, 1, d // h).to(acc)
        mean = (alpha * x_h).sum(dim=1)  # [B, H, Q, d/h]
        if not self.stddev:
            return mean.reshape(b, -1).to(x.dtype)
        std = torch.sqrt(torch.clamp_min((alpha * x_h * x_h).sum(dim=1) - mean * mean, _EPS))
        return torch.cat([mean.reshape(b, -1), std.reshape(b, -1)], dim=-1).to(x.dtype)


class MQMHASPLinear(nn.Module):
    """Query-at-a-time MQMHASP: ``query_0`` .. ``query_{num_q-1}``, one
    single-query MQMHASP each, concatenated."""

    def __init__(self, input_dim: int, num_q: int = 2, num_head: int = 4, hidden_size: int = 128,
                 stddev: bool = True, share: bool = True, affine_layers: int = 2):
        super().__init__()
        self.num_q, self.stddev = max(1, num_q), stddev
        for i in range(self.num_q):
            self.add_module(f"query_{i}", MQMHASP(input_dim, num_q=1, num_head=num_head, hidden_size=hidden_size,
                                                  stddev=stddev, share=share, affine_layers=affine_layers))

    def output_dim(self, input_dim: int) -> int:
        return input_dim * self.num_q * (2 if self.stddev else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.cat([getattr(self, f"query_{i}")(x, mask) for i in range(self.num_q)], dim=-1)


POOLINGS: Dict[str, type] = {
    "statistics": StatisticsPooling,
    "free-statistics": FreeStatisticsPooling,
    "lde": LDEPooling,
    "attentive": AttentiveStatisticsPooling,
    "multi-head": MultiHeadAttentionPooling,
    "global-multi": GlobalMultiHeadAttentionPooling,
    "multi-resolution": MultiResolutionMultiHeadAttentionPooling,
    "mqmha": MQMHASP,
    "mqmha-linear": MQMHASPLinear,
    "xi": XiVectorPooling,
}


def build_pooling(name: str, input_dim: int, params: Optional[dict] = None) -> nn.Module:
    """The pooling ``name`` of the table for ``input_dim``-wide frames."""
    return POOLINGS[name](input_dim=input_dim, **(params or {}))


def pooling_output_dim(name: str, input_dim: int, **kwargs) -> int:
    """Output width of a pooling by name and its parameters."""
    stddev = kwargs.get("stddev", True)
    if name in ("statistics", "free-statistics"):
        return input_dim * (2 if stddev else 1)
    if name == "lde":
        return input_dim * kwargs.get("c_num", 64)
    if name == "xi":
        return input_dim * (2 if kwargs.get("stddev", False) else 1)
    if name in ("attentive", "multi-head"):
        return input_dim * (2 if stddev else 1)
    if name in ("global-multi", "multi-resolution"):
        return input_dim * kwargs.get("num_head", 4) * (2 if stddev else 1)
    if name in ("mqmha", "mqmha-linear"):
        return input_dim * kwargs.get("num_q", 2) * (2 if stddev else 1)
    raise ValueError(f"Unknown pooling {name!r}")
