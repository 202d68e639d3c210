"""ResNet34 x-vector in plain PyTorch: ASV-Subtools' ``resnet-xvector.py``
with the voxcelebSRC ResNet34 recipe's choices.

A 3x3 stem (32 channels, no bias), BN and relu over the [T, F] map;
basic blocks 3-4-6-3 in full pre-activation order (BN, relu, 3x3 conv,
BN, relu, 3x3 conv, plus the identity), 32-64-128-256 channels, the
first block of stages 2-4 at stride 2 with a strided 1x1 conv and BN on
its residual; the map flattened to frames of F' x C values (f major);
statistics pooling (mean and biased std over the valid frames, std
floored at 1e-10 of variance); fc, relu and BN. The trunk's BatchNorms
take no mask; the pooling takes the frame mask subsampled to the
trunk's rate.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .ops import Params, Quant, batch_norm, conv2d, held, linear


def _dims(cfg: dict):
    m = cfg["model"]
    return m["input_dim"], tuple(m["layers"]), m["base_planes"], m["embd_dim"]


def _blocks(cfg: dict):
    """(name, in planes, planes, stride) of every basic block."""
    _, layers, base, _ = _dims(cfg)
    out, in_planes = [], base
    for stage, n in enumerate(layers):
        planes = base * 2 ** stage
        for b in range(n):
            out.append((f"resnet.layer{stage + 1}_{b}", in_planes, planes, 2 if stage > 0 and b == 0 else 1))
            in_planes = planes
    return out


def _out_width(cfg: dict) -> int:
    d_in, layers, base, _ = _dims(cfg)
    f = d_in
    for _ in range(len(layers) - 1):
        f = (f - 1) // 2 + 1
    return f * base * 2 ** (len(layers) - 1)


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter and BN statistic."""
    _, _, base, embd = _dims(cfg)
    specs = []

    def bn(pre, n):
        specs.extend([(f"{pre}.scale", (n,), "bn_scale", 0), (f"{pre}.bias", (n,), "bn_bias", 0),
                      (f"{pre}.mean", (n,), "bn_mean", 0), (f"{pre}.var", (n,), "bn_var", 0)])

    specs.append(("resnet.stem.weight", (base, 1, 3, 3), "weight", 9))
    bn("resnet.stem_bn", base)
    for pre, n_in, planes, stride in _blocks(cfg):
        bn(f"{pre}.bn1", n_in)
        specs.append((f"{pre}.conv1.weight", (planes, n_in, 3, 3), "weight", 9 * n_in))
        bn(f"{pre}.bn2", planes)
        specs.append((f"{pre}.conv2.weight", (planes, planes, 3, 3), "weight", 9 * planes))
        if stride != 1 or n_in != planes:
            specs.append((f"{pre}.downsample_conv.weight", (planes, n_in, 1, 1), "weight", n_in))
            bn(f"{pre}.downsample_bn", planes)
    width = 2 * _out_width(cfg)
    specs.extend([("head.fc2_affine.weight", (embd, width), "weight", width),
                  ("head.fc2_affine.bias", (embd,), "bias", 0)])
    bn("head.fc2_bn", embd)
    return specs


def forward(P: Params, feats: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False,
            q: Quant = None) -> torch.Tensor:
    """feats [B, T, F], frame mask [B, T] -> embedding [B, embd]."""
    x = conv2d(held(feats, q)[:, None], P["resnet.stem.weight"], None, q, padding=1)
    x = torch.relu(batch_norm(P, "resnet.stem_bn", x, None, train, q))
    for pre, stride in _blocks_of(P):
        y = conv2d(torch.relu(batch_norm(P, f"{pre}.bn1", x, None, train, q)), P[f"{pre}.conv1.weight"], None, q,
                   stride=stride, padding=1)
        y = conv2d(torch.relu(batch_norm(P, f"{pre}.bn2", y, None, train, q)), P[f"{pre}.conv2.weight"], None, q,
                   padding=1)
        if f"{pre}.downsample_conv.weight" in P:
            # a strided 1x1 conv, as the 1x1 conv over the cells it reads (oneDNN's
            # CPU backward of the strided form on channels-last maps is unsafe)
            x = batch_norm(P, f"{pre}.downsample_bn",
                           conv2d(x[:, :, ::stride, ::stride], P[f"{pre}.downsample_conv.weight"], None, q),
                           None, train, q)
        x = held(y + x, q)
    b, c, t, f = x.shape
    h = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
    if mask is not None:
        stride = max(1, feats.shape[1] // t)
        mask = mask[:, : t * stride: stride][:, :t]
    z = held(statistics(h, mask), q)
    z = torch.relu(linear(P, "head.fc2_affine", z, q))
    return batch_norm(P, "head.fc2_bn", z, None, train, q)


def _blocks_of(P: Params):
    """(name, stride) of the blocks that P holds, in order: the first block
    of every stage after the first is strided."""
    found = set()
    for k in P:
        if k.startswith("resnet.layer"):
            stage, block = k.split(".")[1][len("layer"):].split("_")
            found.add((int(stage), int(block)))
    return [(f"resnet.layer{s}_{b}", 2 if s > 1 and b == 0 else 1) for s, b in sorted(found)]


def statistics(h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """h [B, T, D] -> [mean, biased std] over the valid frames [B, 2D]."""
    if mask is None:
        mean = h.mean(1)
        var = ((h - mean[:, None]) ** 2).mean(1)
    else:
        m = mask.to(h.dtype)[..., None]
        count = torch.clamp_min(m.sum(1), 1.0)
        mean = (h * m).sum(1) / count
        var = (((h - mean[:, None]) ** 2) * m).sum(1) / count
    return torch.cat([mean, torch.sqrt(torch.clamp_min(var, 1e-10))], dim=-1)


def head_leaves(cfg: dict) -> List[str]:
    """The leaves that no ReLU lies between and the loss: the last BN's."""
    return ["head.fc2_bn.scale", "head.fc2_bn.bias"]


def embd_dim(cfg: dict) -> int:
    return _dims(cfg)[3]


def bn_momentum(name: str, cfg: dict) -> float:
    """The running averages' momentum of the BatchNorm ``name``: the
    model's, 0.5 in every ResNet x-vector BN."""
    return cfg["model"].get("bn_momentum", 0.5)
