"""ECAPA-TDNN (Desplanques et al., arXiv:2005.07143) in plain PyTorch.

The network of ASV-Subtools' ECAPA recipe: a k=5 TDNN layer, three
SE-Res2Net blocks (1x1 conv, a Res2Net chain of scale 8 with k=3 convs
at dilation 2, 3 and 4, 1x1 conv, squeeze-excitation with bottleneck
128, residual) fed with the sums of the earlier blocks' outputs, the
multi-layer aggregation (a 1x1 conv over the three blocks' outputs),
channel-wise attentive statistics pooling with the global context
(mean and std over the valid frames) and a bottleneck of 128, then BN,
fc, relu and BN. Every TDNN layer is conv, relu, BN.

Padding follows the program's semantics for a padded batch: the convs
read whatever the padded frames hold, while the squeeze-excitation
mean, the attention's global statistics and softmax, and (in train
mode) the frame-level BatchNorms take only the valid frames. The
pooled statistics' std uses the weighted second central moment.

Parameters are a flat dict under the program's state_dict names, so
one seeded dict feeds both sides. ``param_specs`` lists them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .ops import Params, Quant, batch_norm, conv1d, held, linear, masked_mean, matmul

SCALE = 8
SE_BOTTLENECK = 128
ATT_BOTTLENECK = 128


def _dims(cfg: dict) -> Tuple[int, int, int, int]:
    m = cfg["model"]
    return m["input_dim"], m["channels"], m["mfa_conv"], m["embd_dim"]


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter and BN statistic."""
    d_in, c, mfa, embd = _dims(cfg)
    specs = []

    def bn(pre, n):
        specs.extend([(f"{pre}.scale", (n,), "bn_scale", 0), (f"{pre}.bias", (n,), "bn_bias", 0),
                      (f"{pre}.mean", (n,), "bn_mean", 0), (f"{pre}.var", (n,), "bn_var", 0)])

    def tdnn(pre, n_in, n_out, k):
        specs.extend([(f"{pre}.affine.conv.weight", (n_out, n_in, k), "weight", n_in * k),
                      (f"{pre}.affine.conv.bias", (n_out,), "bias", 0)])
        bn(f"{pre}.act_bn.bn", n_out)

    def dense(pre, n_in, n_out):
        specs.extend([(f"{pre}.weight", (n_out, n_in), "weight", n_in), (f"{pre}.bias", (n_out,), "bias", 0)])

    tdnn("layer1", d_in, c, 5)
    h = c // SCALE
    for i in (2, 3, 4):
        tdnn(f"layer{i}.conv1", c, c, 1)
        for j in range(SCALE - 1):
            tdnn(f"layer{i}.res2net.block_{j}", h, h, 3)
        tdnn(f"layer{i}.conv2", c, c, 1)
        dense(f"layer{i}.se.fc1", c, SE_BOTTLENECK)
        dense(f"layer{i}.se.fc2", SE_BOTTLENECK, c)
    tdnn("mfa", 3 * c, mfa, 1)
    specs.extend([("stats.att1.kernel", (1, 3 * mfa, ATT_BOTTLENECK), "weight", 3 * mfa),
                  ("stats.att1.bias", (ATT_BOTTLENECK,), "bias", 0)])
    bn("stats.att_bn", ATT_BOTTLENECK)
    specs.extend([("stats.att2.weight", (mfa, ATT_BOTTLENECK, 1), "weight", ATT_BOTTLENECK),
                  ("stats.att2.bias", (mfa,), "bias", 0)])
    bn("bn_stats", 2 * mfa)
    dense("fc2_affine", 2 * mfa, embd)
    bn("fc2_bn", embd)
    return specs


def _tdnn(P: Params, pre: str, x, mask, train: bool, q: Quant, dilation: int = 1):
    w = P[f"{pre}.affine.conv.weight"]
    pad = dilation * (w.shape[-1] // 2)
    y = conv1d(x, w, P[f"{pre}.affine.conv.bias"], q, padding=pad, dilation=dilation)
    return batch_norm(P, f"{pre}.act_bn.bn", torch.relu(y), mask, train, q)


def _se_res2(P: Params, pre: str, x, mask, train: bool, q: Quant, dilation: int):
    y = _tdnn(P, f"{pre}.conv1", x, mask, train, q)
    parts = torch.chunk(y, SCALE, dim=1)
    outs, sp = [parts[0]], None
    for j in range(SCALE - 1):
        sp = parts[j + 1] if j == 0 else held(sp + parts[j + 1], q)
        sp = _tdnn(P, f"{pre}.res2net.block_{j}", sp, mask, train, q, dilation)
        outs.append(sp)
    y = _tdnn(P, f"{pre}.conv2", torch.cat(outs, dim=1), mask, train, q)
    s = torch.relu(linear(P, f"{pre}.se.fc1", held(masked_mean(y, mask), q), q))
    s = held(torch.sigmoid(linear(P, f"{pre}.se.fc2", s, q)), q)
    return held(held(y * s[..., None], q) + x, q)


def attentive_stats(P: Params, y: torch.Tensor, mask: Optional[torch.Tensor], train: bool, q: Quant):
    """y [B, C, T] -> [B, 2C]: attention over [y; mean; std] per channel."""
    c = y.shape[1]
    if mask is None:
        mean = y.mean(-1)
        var = y.var(-1, unbiased=True)
    else:
        m = mask.to(y.dtype)[:, None, :]
        count = torch.clamp_min(m.sum(-1), 1.0)
        mean = (y * m).sum(-1) / count
        var = (((y - mean[..., None]) ** 2) * m).sum(-1) / torch.clamp_min(count - 1.0, 1.0)
    std = torch.sqrt(var + 1e-5)
    k = P["stats.att1.kernel"][0]
    glob = matmul(mean, k[c:2 * c], q) + matmul(std, k[2 * c:], q) + P["stats.att1.bias"]
    a = torch.relu(matmul(k[:c].t(), y, q) + glob[..., None])
    a = batch_norm(P, "stats.att_bn", a, mask, train, q)
    a = conv1d(torch.tanh(a), P["stats.att2.weight"], P["stats.att2.bias"], q)
    if mask is not None:
        a = a.masked_fill(~mask[:, None, :], float("-inf"))
    alpha = torch.softmax(a, dim=-1)
    mu = (alpha * y).sum(-1)
    var = (alpha * (y - mu[..., None]) ** 2).sum(-1)
    return torch.cat([mu, torch.sqrt(torch.clamp_min(var, 1e-5))], dim=-1)


def forward(P: Params, feats: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False,
            q: Quant = None) -> torch.Tensor:
    """feats [B, T, D], frame mask [B, T] -> embedding [B, embd]."""
    h = _tdnn(P, "layer1", held(feats, q).transpose(1, 2), mask, train, q)
    x1 = _se_res2(P, "layer2", h, mask, train, q, 2)
    s1 = held(h + x1, q)
    x2 = _se_res2(P, "layer3", s1, mask, train, q, 3)
    x3 = _se_res2(P, "layer4", held(s1 + x2, q), mask, train, q, 4)
    y = _tdnn(P, "mfa", torch.cat([x1, x2, x3], dim=1), mask, train, q)
    z = batch_norm(P, "bn_stats", held(attentive_stats(P, y, mask, train, q), q), None, train, q)
    z = torch.relu(linear(P, "fc2_affine", z, q))
    return batch_norm(P, "fc2_bn", z, None, train, q)


def head_leaves(cfg: dict) -> List[str]:
    """The leaves that no ReLU lies between and the loss: the last BN's."""
    return ["fc2_bn.scale", "fc2_bn.bias"]


def embd_dim(cfg: dict) -> int:
    return _dims(cfg)[3]


def bn_momentum(name: str, cfg: dict) -> float:
    """The running averages' momentum of the BatchNorm ``name``: the
    model's (0.5) but for the attentive pooling's, which keeps 0.1."""
    return 0.1 if name == "stats.att_bn" else cfg["model"].get("bn_momentum", 0.5)
