"""TDNN building blocks (counterpart: asv_subtools_tpu/nn/tdnn.py:44-503).

Inside the port's model activations are ``[B, C, T]``, the layout of
``F.conv1d``, so a layer needs no transpose. ``TdnnAffine`` runs an evenly
spaced context as one dilated conv (``conv``) and an irregular one as
shifted slices stacked on the channel axis into one product (``affine``,
a Dense over ``len(context) * in`` inputs, context-major), the JAX
module's two parameter layouts. The layers hand a ``[B, T]`` mask to
their BatchNorm, whose train mode leaves padded frames out of the batch
statistics.

The rest of JAX's library (AdaptivePCMN, SoftmaxAffineLayer, GruAffine,
ImportantScale, MultiAffine, ChunkSeparationAffine and the batch
:func:`mixup`) is at the end of the module; the train step's mixup goes
through :func:`mixup_draw`.

The F-TDNN's semi-orthogonal constraint is a function on weights
(:func:`semi_orth_update`, :func:`apply_semi_orth_constraint`) that the
train step applies to the f32 masters every fourth step. A factor's
weight ``[O, I, W]`` is the matrix ``M[o, w*I + i]`` of the JAX kernel
``[W, I, O]``: ``weight.permute(0, 2, 1).reshape(O, W*I)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .activations import get_activation
from .norm import BatchNorm


def _context_info(context: Sequence[int]) -> Tuple[bool, int, int]:
    """(evenly spaced, dilation, kernel_size) of a sorted context."""
    ctx = list(context)
    if ctx != sorted(ctx):
        raise ValueError(f"context must be sorted, got {context}")
    if len(ctx) == 1:
        return True, 1, 1
    gaps = {ctx[i + 1] - ctx[i] for i in range(len(ctx) - 1)}
    if len(gaps) == 1:
        return True, gaps.pop(), len(ctx)
    return False, 1, len(ctx)


class TdnnAffine(nn.Module):
    """y_t = b + sum_i W_i x_{t+ctx_i}.

    x [B, C_in, T] -> [B, C_out, T']. ``pad=True`` zero-pads the edges to
    keep T; ``pad=False`` shrinks it by the context's span. An evenly
    spaced context is ``conv`` (``weight [out, in/groups, k]``); an
    irregular one is ``affine`` (``weight [out, len(ctx)*in]``), which, as
    the JAX module's Dense, takes no groups.
    """

    def __init__(self, input_dim: int, output_dim: int, context: Sequence[int] = (0,), pad: bool = True,
                 stride: int = 1, groups: int = 1, use_bias: bool = True):
        super().__init__()
        if input_dim % groups or output_dim % groups:
            raise ValueError("groups must divide input and output dims")
        self.context = tuple(context)
        self.even, dilation, ksize = _context_info(self.context)
        self.stride = stride
        self.pad = (-self.context[0], self.context[-1]) if pad else (0, 0)
        if self.even:
            same = self.pad[0] == self.pad[1]
            self.conv = nn.Conv1d(input_dim, output_dim, ksize, stride=stride, dilation=dilation,
                                  padding=self.pad[0] if same else 0, groups=groups, bias=use_bias)
            self._explicit_pad = not same
        else:
            self.affine = nn.Linear(input_dim * len(self.context), output_dim, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.even:
            return self.conv(F.pad(x, self.pad) if self._explicit_pad else x)
        left = -self.context[0]
        xp = F.pad(x, self.pad)
        t_out = xp.shape[-1] - left - self.context[-1]
        stacked = torch.cat([xp[..., c + left:c + left + t_out] for c in self.context], dim=1)
        y = F.conv1d(stacked, self.affine.weight[..., None], self.affine.bias)
        return y[..., ::self.stride] if self.stride > 1 else y


class ActivationBatchNorm(nn.Module):
    """activation then BatchNorm (``bn_relu=False``, the default), or
    BatchNorm then activation. ``affine=False`` is the snowdar family's
    non-affine BN; ``bn=False`` leaves the BN out."""

    def __init__(self, features: int, momentum: float = 0.1, activation: Optional[str] = "relu", bn: bool = True,
                 bn_relu: bool = False, affine: bool = True):
        super().__init__()
        self.act = get_activation(activation)
        self.bn_relu = bn_relu
        self.bn = BatchNorm(features, momentum=momentum, use_scale=affine, use_bias=affine) if bn else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.bn_relu and self.bn is not None:
            x = self.bn(x, mask)
        if self.act is not None:
            x = self.act(x)
        if not self.bn_relu and self.bn is not None:
            x = self.bn(x, mask)
        return x


class ReluBatchNormTdnnLayer(nn.Module):
    """TdnnAffine + ReLU + BN, the standard x-vector layer."""

    def __init__(self, input_dim: int, output_dim: int, context: Sequence[int] = (0,), momentum: float = 0.1, *,
                 activation: Optional[str] = "relu", bn: bool = True, bn_relu: bool = False, pad: bool = True,
                 stride: int = 1, groups: int = 1, use_bias: bool = True, bn_affine: bool = True):
        super().__init__()
        self.affine = TdnnAffine(input_dim, output_dim, context, pad=pad, stride=stride, groups=groups,
                                 use_bias=use_bias)
        self.act_bn = ActivationBatchNorm(output_dim, momentum, activation=activation, bn=bn, bn_relu=bn_relu,
                                          affine=bn_affine)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.act_bn(self.affine(x), mask)


class FTdnnBlock(nn.Module):
    """Factorised TDNN block: ``factor1`` (the bottleneck, no bias, under the
    semi-orthogonal constraint) -> ``factor2`` -> relu -> BN, plus
    ``bypass_scale`` times the input (input_dim == output_dim then).
    ``context_size`` c gives factor1 the context [-c, 0] and factor2 [0, c]
    (c = 0: both [0])."""

    def __init__(self, input_dim: int, output_dim: int, bottleneck_dim: int, context_size: int = 0,
                 bypass_scale: float = 0.0, momentum: float = 0.1):
        super().__init__()
        c = context_size
        self.bypass_scale = bypass_scale
        self.factor1 = TdnnAffine(input_dim, bottleneck_dim, (-c, 0) if c > 0 else (0,), use_bias=False)
        self.factor2 = TdnnAffine(bottleneck_dim, output_dim, (0, c) if c > 0 else (0,))
        self.bn = BatchNorm(output_dim, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.bn(torch.relu(self.factor2(self.factor1(x))), mask)
        return y + self.bypass_scale * x if self.bypass_scale != 0.0 else y


def _weight_to_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv weight [O, I, W] -> M [O, W*I], the JAX kernel's matrix."""
    o, i, w = weight.shape
    return weight.permute(0, 2, 1).reshape(o, w * i)


def _matrix_to_weight(m: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    o, i, w = shape
    return m.reshape(o, w, i).permute(0, 2, 1)


def semi_orth_objective(weight: torch.Tensor) -> torch.Tensor:
    """||P - scale I||^2 with P = M M^T and scale = tr(P P) / tr(P), of a
    conv weight [O, I, W]: 0 for a semi-orthogonal factor (up to scale)."""
    m = _weight_to_matrix(weight.to(torch.promote_types(weight.dtype, torch.float32)))
    p = m @ m.T
    scale = torch.trace(p @ p) / torch.clamp_min(torch.trace(p), 1e-10)
    return ((p - scale * torch.eye(p.shape[0], dtype=p.dtype, device=p.device)) ** 2).sum()


def semi_orth_update(weight: torch.Tensor) -> torch.Tensor:
    """One step of Kaldi's floating-scale semi-orthogonal update of a conv
    weight [O, I, W], in at least float32 (float64 when given float64):
    P = M M^T, scale^2 = tr(P P) / tr(P), M <- M - 4 alpha (P - scale^2 I) M
    with alpha = speed / scale^2, speed 0.125 halved past the ratio 1.02
    and again past 1.1 (JAX nn/tdnn.py:271-317). M is the wide way round
    (rows <= columns). Branch-free: no value is read on the host."""
    m = _weight_to_matrix(weight.to(torch.promote_types(weight.dtype, torch.float32)))
    transposed = m.shape[0] > m.shape[1]
    if transposed:
        m = m.T
    p = m @ m.T
    trace_p, trace_pp = torch.trace(p), torch.trace(p @ p)
    scale2 = trace_pp / torch.clamp_min(trace_p, 1e-10)
    d = p.shape[0]
    ratio = trace_pp * d / torch.clamp_min(trace_p * trace_p, 1e-10)
    speed = 0.125 * torch.where(ratio > 1.1, 0.25, torch.where(ratio > 1.02, 0.5, 1.0))
    p = p - scale2 * torch.eye(d, dtype=p.dtype, device=p.device)
    alpha = speed / torch.clamp_min(scale2, 1e-10)
    m = m - 4.0 * alpha * (p @ m)
    if transposed:
        m = m.T
    return _matrix_to_weight(m, weight.shape).to(weight.dtype)


def is_semi_orth_weight(name: str, value: torch.Tensor) -> bool:
    """A state_dict key of an F-TDNN ``factor1`` conv weight."""
    return name.endswith(".weight") and "factor1" in name.split(".") and value.dim() == 3


def apply_semi_orth_constraint(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The semi-orthogonal update of every ``factor1`` weight of a dict of
    state_dict tensors; the other entries pass through."""
    return {k: semi_orth_update(v) if is_semi_orth_weight(k, v) else v for k, v in params.items()}


class SEBlock(nn.Module):
    """Squeeze-and-excitation over time: x [B, C, T] times a gate read from
    the mean over valid frames (in x's type)."""

    def __init__(self, channels: int, ratio: int = 4, inner_dim: Optional[int] = None):
        super().__init__()
        hidden = inner_dim if inner_dim is not None else channels // ratio
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            s = x.mean(dim=-1)
        else:
            m = mask.to(x.dtype)[:, None, :]
            s = (x * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
        return x * s[..., None]


class SEBlock2D(nn.Module):
    """Squeeze-and-excitation over (T, F) maps for the 2-D backbones.
    x [B, C, T, F]: the gate reads the mean over T and F."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(1, channels // ratio))
        self.fc2 = nn.Linear(max(1, channels // ratio), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(-2, -1))
        s = torch.relu(self.fc1(s))
        s = torch.sigmoid(self.fc2(s))
        return x * s[..., None, None]


# ---------------------------------------------------------------------------
# The rest of the layer library (JAX nn/tdnn.py:384-503). AdaptivePCMN
# takes the TDNNs' [B, D, T]; the Dense-based layers act on the last axis
# of channels-last [..., T, D], as the JAX modules do.
# ---------------------------------------------------------------------------


class AdaptivePCMN(nn.Module):
    """Adaptive parametric cepstral mean normalisation: x [B, D, T] ->
    ``alpha(x) * x + beta(x) * m`` with ``m`` the mean over the context
    window of each frame (zero-padded edges, always divided by the window's
    length), ``alpha = 1 + tanh(TdnnAffine(x))`` and ``beta = -1 +
    tanh(TdnnAffine(x))`` over the same context."""

    def __init__(self, input_dim: int, left_context: int = -10, right_context: int = 10):
        super().__init__()
        self.left, self.right = -left_context, right_context
        ctx = tuple(range(left_context, right_context + 1))
        self.alpha = TdnnAffine(input_dim, input_dim, context=ctx)
        self.beta = TdnnAffine(input_dim, input_dim, context=ctx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t = self.left + self.right + 1, x.shape[-1]
        csum = F.pad(torch.cumsum(F.pad(x, (self.left, self.right)), dim=-1), (1, 0))
        window_mean = (csum[..., n:n + t] - csum[..., :t]) / float(n)
        alpha = 1.0 + torch.tanh(self.alpha(x))
        beta = -1.0 + torch.tanh(self.beta(x))
        return alpha * x + beta * window_mean


class SoftmaxAffineLayer(nn.Module):
    """Dense then log-softmax (``log=True``) or softmax over the last axis."""

    def __init__(self, input_dim: int, output_dim: int, log: bool = True):
        super().__init__()
        self.log = log
        self.affine = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.affine(x)
        return torch.log_softmax(y, dim=-1) if self.log else torch.softmax(y, dim=-1)


class _GruCell(nn.Module):
    """flax GRUCell's parameters: input Dense ``ir``, ``iz``, ``in`` with
    bias, hidden Dense ``hr``, ``hz`` without and ``hn`` with."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        for gate in ("ir", "iz", "in"):
            self.add_module(gate, nn.Linear(input_dim, hidden))
        self.hr = nn.Linear(hidden, hidden, bias=False)
        self.hz = nn.Linear(hidden, hidden, bias=False)
        self.hn = nn.Linear(hidden, hidden)


class GruAffine(nn.Module):
    """A GRU over the time axis of x [B, T, D] from a zero state -> [B, T, H]
    (flax ``nn.RNN(nn.GRUCell)``): r = sigmoid(ir(x) + hr(h)), z =
    sigmoid(iz(x) + hz(h)), n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n +
    z * h. It runs as ``torch.gru`` (cuDNN's on the card) on weights
    stacked from the cell's Dense layers. torch's GRU adds a hidden bias to
    the r and z gates, which flax has not: those two slices are constant
    zeros, not parameters, so no step moves them."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.output_dim = output_dim
        self.cell = _GruCell(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cell
        h = self.output_dim
        zeros = torch.zeros(2 * h, dtype=x.dtype, device=x.device)
        weights = [torch.cat([c.ir.weight, c.iz.weight, getattr(c, "in").weight]).to(x.dtype),
                   torch.cat([c.hr.weight, c.hz.weight, c.hn.weight]).to(x.dtype),
                   torch.cat([c.ir.bias, c.iz.bias, getattr(c, "in").bias]).to(x.dtype),
                   torch.cat([zeros, c.hn.bias.to(x.dtype)])]
        h0 = torch.zeros((1, x.shape[0], h), dtype=x.dtype, device=x.device)
        out, _ = torch.gru(x, h0, weights, True, 1, 0.0, self.training, False, True)
        return out


class ImportantScale(nn.Module):
    """x [..., D] times ``w**2 / max(max(w**2), 1e-12)``, a learned
    per-feature gate (``scale``, ones at init)."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(input_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale * self.scale
        return x * (s / torch.clamp_min(s.max(), 1e-12))


class MultiAffine(nn.Module):
    """The mean of ``num_affine`` Dense layers (``affine_i``), each after
    ``activation`` (none for ``None``)."""

    def __init__(self, input_dim: int, output_dim: int, num_affine: int = 2, activation: Optional[str] = "relu"):
        super().__init__()
        self.act = get_activation(activation)
        self.num_affine = num_affine
        for i in range(num_affine):
            self.add_module(f"affine_{i}", nn.Linear(input_dim, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [getattr(self, f"affine_{i}")(x) for i in range(self.num_affine)]
        if self.act is not None:
            outs = [self.act(y) for y in outs]
        return sum(outs) / self.num_affine


class ChunkSeparationAffine(nn.Module):
    """x [..., T, D]: Dense ``first`` on frames [0, T // 2), ``second`` on
    the rest, joined back along T."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.first = nn.Linear(input_dim, output_dim)
        self.second = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.shape[-2] // 2
        return torch.cat([self.first(x[..., :half, :]), self.second(x[..., half:, :])], dim=-2)


def mixup_draw(batch: int, alpha: float, generator: Optional[torch.Generator], device: torch.device,
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lam ~ Beta(alpha, alpha) as a 0-dim ``dtype`` tensor, a random
    permutation of the batch), drawn from ``generator`` on ``device``; no
    value reaches the host. Beta is g1 / (g1 + g2) of two Gamma(alpha)
    draws (``torch.distributions.Beta`` takes no generator)."""
    g = torch._standard_gamma(torch.full((2,), float(alpha), dtype=dtype, device=device), generator=generator)
    return g[0] / (g[0] + g[1]), torch.randperm(batch, generator=generator, device=device)


def mixup(x: torch.Tensor, generator: Optional[torch.Generator], alpha: float = 1.0
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch mixup -> (``lam * x + (1 - lam) * x[index]`` in x's type,
    lam, index), lam and index from :func:`mixup_draw` (the train step's
    draw goes through it). The mix is computed in at least float32."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    lam, index = mixup_draw(x.shape[0], alpha, generator, x.device, dtype)
    xf = x.to(dtype)
    return (lam * xf + (1.0 - lam) * xf[index]).to(x.dtype), lam, index
