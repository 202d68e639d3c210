"""The Conformer x-vector in plain PyTorch: ASV-Subtools' "6L-256D-4H-2Sub"
of the voxcelebSRC recipe, whose blocks follow Gulati et al.
(arXiv:2005.08100) in wenet's form.

- ``conv2d2`` subsampling: a 3x3 conv from 1 to D channels at stride
  (2, 1) over the [T, F] map, relu, a 3x3 conv from D to D, relu (both
  without padding), the [T', F' x D] map (channels fastest) through a
  Dense to D, times sqrt(D). The frame mask becomes
  ``mask[:, 2::2][:, :T']``.
- Pre-norm macaron blocks: ``x += FFN(LN x) / 2`` (D to the feed-forward
  width, swish, back to D); ``x += MHSA_rel(LN x)``; ``x += Conv(LN x)``;
  ``x += FFN(LN x) / 2``; ``x = LN x``.
- ``MHSA_rel``: a fused q, k, v Dense, H heads of D / H; ``p = W_pos
  table`` (no bias); raw scores ``(q + u) k^T + (q + v) p^T`` over
  sqrt(D / H); the softmax over the keys; the product with v; the
  output Dense.
- ``Conv``: a pointwise conv from D to 2D, GLU, a depthwise conv of
  kernel 15 ("SAME": 7 frames each side), LayerNorm, swish, a pointwise
  conv from D to D.
- After the blocks ``after_norm``; ``transform_out``: a Dense to the
  pooling width, swish, LayerNorm; ECAPA's attentive statistics pooling
  without the global context (a 1x1 conv to 128, relu, LayerNorm, tanh,
  a 1x1 conv back, a softmax over the valid frames per channel, the
  weighted mean and std); LayerNorm; a Dense to the embedding; relu;
  LayerNorm. Every LayerNorm takes epsilon 1e-5.

Departures from the published description, which are the program's and
the recipe's own:

- the position table is the sinusoid of the absolute positions
  0..T'-1 (sin on even columns, cos on odd), with no rel-shift: the
  recipe's relative attention uses it so;
- a masked score (a padded key or query frame) is set to -1e9, not
  -inf, before the softmax, and the weights are zeroed there after it,
  so a padded query row gives zeros, not NaN;
- the convolution module zeroes the padded frames of its input and of
  its output;
- the pooled std is the weighted second central moment, floored at
  1e-5 of variance.

Parameters are a flat dict under the program's state_dict names, so
one seeded dict feeds both sides; LayerNorm scales and shifts take the
kinds of a BatchNorm's (``bn_scale``, ``bn_bias``). Extraction only: the
forward runs in eval mode (no dropout), and any option of the program
other than these widths is refused. Every shape is static (no
``.item()``), so the forward runs on the meta device for the FLOP count.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .ops import Params, Quant, conv1d, conv2d, held, linear, matmul

KERNEL = 15  # the depthwise conv's kernel (wenet's default)
POOL_BOTTLENECK = 128
LN_EPS = 1e-5
NEG_INF = -1.0e9
FIXED = {"input_layer": "conv2d2", "pos_enc_type": "rel_pos", "transformer_type": "conformer",
         "combiner_type": "norm", "pooling": "ecpa-attentive"}


def _dims(cfg: dict) -> Tuple[int, int, int, int, int, int, int]:
    m = cfg["model"]
    for key, value in FIXED.items():
        if m.get(key, value) != value:
            raise ValueError(f"the reference builds {key} {value!r} only, not {m[key]!r}")
    return (m["input_dim"], m["attention_dim"], m["attention_heads"], m["linear_units"], m["num_blocks"],
            m["out_dim"], m["embd_dim"])


def subsampled_frames(frames: int) -> int:
    """T' of ``conv2d2`` over T frames: (T - 3) // 2 + 1, then - 2."""
    return (frames - 3) // 2 - 1


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter."""
    d_in, d, heads, units, blocks, out, embd = _dims(cfg)
    specs = []

    def dense(pre, n_in, n_out, bias=True):
        specs.append((f"{pre}.weight", (n_out, n_in), "weight", n_in))
        if bias:
            specs.append((f"{pre}.bias", (n_out,), "bias", 0))

    def conv(pre, shape, fan_in):
        specs.extend([(f"{pre}.weight", shape, "weight", fan_in), (f"{pre}.bias", (shape[0],), "bias", 0)])

    def norm(pre, n):
        specs.extend([(f"{pre}.scale", (n,), "bn_scale", 0), (f"{pre}.bias", (n,), "bn_bias", 0)])

    conv("transformer.embed.conv1", (d, 1, 3, 3), 9)
    conv("transformer.embed.conv2", (d, d, 3, 3), 9 * d)
    dense("transformer.embed.proj", (d_in - 4) * d, d)
    for i in range(blocks):
        pre = f"transformer.block_{i}"
        norm(f"{pre}.norm_ff_macaron", d)
        dense(f"{pre}.ff_macaron.w1", d, units)
        dense(f"{pre}.ff_macaron.w2", units, d)
        norm(f"{pre}.norm_mha", d)
        specs.extend([(f"{pre}.self_attn.pos_bias_u", (heads, d // heads), "weight", d // heads),
                      (f"{pre}.self_attn.pos_bias_v", (heads, d // heads), "weight", d // heads)])
        dense(f"{pre}.self_attn.out", d, d)
        dense(f"{pre}.self_attn.qkv", d, 3 * d)
        dense(f"{pre}.self_attn.pos", d, d, bias=False)
        norm(f"{pre}.norm_conv", d)
        conv(f"{pre}.conv_module.pointwise1", (2 * d, d, 1), d)
        conv(f"{pre}.conv_module.depthwise", (d, 1, KERNEL), KERNEL)
        norm(f"{pre}.conv_module.norm", d)
        conv(f"{pre}.conv_module.pointwise2", (d, d, 1), d)
        norm(f"{pre}.norm_ff", d)
        dense(f"{pre}.ff.w1", d, units)
        dense(f"{pre}.ff.w2", units, d)
        norm(f"{pre}.norm_final", d)
    norm("transformer.after_norm", d)
    dense("transform_out_affine", d, out)
    norm("transform_out_norm", out)
    conv("stats.att1", (POOL_BOTTLENECK, out, 1), out)
    norm("stats.att_norm", POOL_BOTTLENECK)
    conv("stats.att2", (out, POOL_BOTTLENECK, 1), POOL_BOTTLENECK)
    norm("bn_stats", 2 * out)
    dense("fc2_affine", 2 * out, embd)
    norm("fc2_norm", embd)
    return specs


def layer_norm(P: Params, pre: str, x: torch.Tensor, q: Quant) -> torch.Tensor:
    """LayerNorm ``pre`` over the last axis, its statistics in float32."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    return held(y * held(P[pre + ".scale"], q) + held(P[pre + ".bias"], q), q)


def position_table(t: int, dim: int, device) -> torch.Tensor:
    """The sinusoid of positions 0..t-1, [t, dim]: sin on the even columns,
    cos on the odd, computed in float64 and rounded to float32."""
    pos = torch.arange(t, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=device) * -(math.log(10000.0) / dim))
    angle = pos * div
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(t, dim).to(torch.float32)


def _subsample(P: Params, feats: torch.Tensor, mask: Optional[torch.Tensor], q: Quant):
    pre = "transformer.embed"
    h = torch.relu(conv2d(held(feats, q)[:, None], P[f"{pre}.conv1.weight"], P[f"{pre}.conv1.bias"], q,
                          stride=(2, 1)))
    h = torch.relu(conv2d(h, P[f"{pre}.conv2.weight"], P[f"{pre}.conv2.bias"], q))
    b, c, t, f = h.shape
    h = linear(P, f"{pre}.proj", h.permute(0, 2, 3, 1).reshape(b, t, f * c), q)
    if mask is not None:
        mask = mask[:, 2::2][:, :t]
    return held(h * math.sqrt(c), q), mask


def _feed_forward(P: Params, pre: str, x: torch.Tensor, q: Quant) -> torch.Tensor:
    return linear(P, f"{pre}.w2", held(F.silu(linear(P, f"{pre}.w1", x, q)), q), q)


def _attention(P: Params, pre: str, x: torch.Tensor, att_mask: Optional[torch.Tensor], heads: int,
               q: Quant) -> torch.Tensor:
    """Relative-position self-attention over x [B, T, D]; att_mask [B, 1, T, T]
    (True = attend) or None."""
    b, t, d = x.shape
    dh = d // heads
    qkv = linear(P, f"{pre}.qkv", x, q).view(b, t, 3, heads, dh)
    qh, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, Dh]
    table = held(position_table(t, d, x.device), q)
    p = matmul(table, P[f"{pre}.pos.weight"].t(), q).view(t, heads, dh).transpose(0, 1)  # [H, T, Dh]
    u = held(P[f"{pre}.pos_bias_u"], q)[None, :, None, :]
    w = held(P[f"{pre}.pos_bias_v"], q)[None, :, None, :]
    ac = matmul(held(qh + u, q), k.transpose(-1, -2), q)
    bd = matmul(held(qh + w, q), p.transpose(-1, -2), q)
    scores = (ac + bd) / math.sqrt(dh)
    if att_mask is not None:
        scores = scores.masked_fill(~att_mask, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if att_mask is not None:
        attn = attn.masked_fill(~att_mask, 0.0)
    out = matmul(held(attn, q), v, q)  # [B, H, T, Dh]
    return linear(P, f"{pre}.out", out.transpose(1, 2).reshape(b, t, d), q)


def _conv_module(P: Params, pre: str, x: torch.Tensor, mask: Optional[torch.Tensor], q: Quant) -> torch.Tensor:
    m = None if mask is None else mask.to(x.dtype)[..., None]
    if m is not None:
        x = x * m
    w1 = P[f"{pre}.pointwise1.weight"][..., 0]
    h = held(F.glu(held(matmul(x, w1.t(), q) + held(P[f"{pre}.pointwise1.bias"], q), q), dim=-1), q)
    dw = P[f"{pre}.depthwise.weight"]
    h = conv1d(h.transpose(1, 2), dw, P[f"{pre}.depthwise.bias"], q, padding=KERNEL // 2, groups=dw.shape[0])
    h = held(F.silu(layer_norm(P, f"{pre}.norm", h.transpose(1, 2), q)), q)
    w2 = P[f"{pre}.pointwise2.weight"][..., 0]
    h = held(matmul(h, w2.t(), q) + held(P[f"{pre}.pointwise2.bias"], q), q)
    return h if m is None else h * m


def _block(P: Params, pre: str, x: torch.Tensor, att_mask, mask, heads: int, q: Quant) -> torch.Tensor:
    x = held(x + 0.5 * _feed_forward(P, f"{pre}.ff_macaron", layer_norm(P, f"{pre}.norm_ff_macaron", x, q), q), q)
    x = held(x + _attention(P, f"{pre}.self_attn", layer_norm(P, f"{pre}.norm_mha", x, q), att_mask, heads, q), q)
    x = held(x + _conv_module(P, f"{pre}.conv_module", layer_norm(P, f"{pre}.norm_conv", x, q), mask, q), q)
    x = held(x + 0.5 * _feed_forward(P, f"{pre}.ff", layer_norm(P, f"{pre}.norm_ff", x, q), q), q)
    return layer_norm(P, f"{pre}.norm_final", x, q)


def attentive_stats(P: Params, h: torch.Tensor, mask: Optional[torch.Tensor], q: Quant) -> torch.Tensor:
    """h [B, T, C] -> [B, 2C]: per-channel attention over the valid frames,
    the weighted mean and std."""
    xc = h.transpose(1, 2)  # [B, C, T]
    a = torch.relu(conv1d(xc, P["stats.att1.weight"], P["stats.att1.bias"], q))
    a = layer_norm(P, "stats.att_norm", a.transpose(1, 2), q).transpose(1, 2)
    a = conv1d(held(torch.tanh(a), q), P["stats.att2.weight"], P["stats.att2.bias"], q)
    if mask is not None:
        a = a.masked_fill(~mask[:, None, :], float("-inf"))
    alpha = held(torch.softmax(a, dim=-1), q)
    mu = (alpha * xc).sum(-1)
    var = (alpha * (xc - mu[..., None]) ** 2).sum(-1)
    return torch.cat([mu, torch.sqrt(torch.clamp_min(var, 1e-5))], dim=-1)


def forward(P: Params, feats: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False,
            q: Quant = None) -> torch.Tensor:
    """feats [B, T, F], frame mask [B, T] -> embedding [B, embd]."""
    if train:
        raise NotImplementedError("the Conformer reference covers extraction (eval mode) only")
    heads = P["transformer.block_0.self_attn.pos_bias_u"].shape[0]
    x, mask = _subsample(P, feats, mask, q)
    att_mask = None if mask is None else mask[:, None, None, :] & mask[:, None, :, None]
    blocks = sorted({int(k.split(".")[1][len("block_"):]) for k in P if k.startswith("transformer.block_")})
    for i in blocks:
        x = _block(P, f"transformer.block_{i}", x, att_mask, mask, heads, q)
    x = layer_norm(P, "transformer.after_norm", x, q)
    x = layer_norm(P, "transform_out_norm", held(F.silu(linear(P, "transform_out_affine", x, q)), q), q)
    z = layer_norm(P, "bn_stats", held(attentive_stats(P, x, mask, q), q), q)
    z = held(torch.relu(linear(P, "fc2_affine", z, q)), q)
    return layer_norm(P, "fc2_norm", z, q)


def embd_dim(cfg: dict) -> int:
    return _dims(cfg)[6]
