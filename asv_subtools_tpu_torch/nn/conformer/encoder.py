"""Conformer and Transformer encoders (counterpart:
asv_subtools_tpu/nn/conformer/encoder.py:34-577).

``[B, T, F]`` features (+ a ``[B, T]`` mask) -> the input subsampling ->
the positions -> the blocks -> the combiner -> ``after_norm`` ->
``[B, T', output_dim]`` and the subsampled mask. Channels-last
throughout; module names follow the flax modules.

The positions (JAX :467-486): "rel_pos" scales by sqrt(d) and the
relative attention builds the table of positions 0..T'-1; "abs_pos" is
``x * sqrt(d) + table``; "rot_pos" scales by sqrt(d) (or, with
``rope_abs_plus``, is abs_pos) and rotates q and k inside the attention;
"no_pos" neither scales nor adds.

A block (``ConformerBlock``, JAX :150-345): an optional macaron half
feed-forward, self-attention (with a per-layer T5 bias under
``add_t5rel_bias``; ``concat_after`` adds ``concat_linear([h, att(h)])``
with no scale and no dropout), an optional convolution module (causal
under a static chunk), the feed-forward and ``norm_final``; pre-norm, or
post-norm when ``normalize_before`` is False. The feed-forwards are
"linear" (Dense, :52-68), "conv1d" (``MultiLayeredConv1d``, :71-90),
"conv1d-linear" (``Conv1dLinear``, :93-113) or "gau" (a GAU whose
``key_dim`` is always 64, whatever ``gau_key`` says: JAX :257-268 keeps
the reference's quirk). The first ``convfnn_blocks`` blocks take a
conv1d feed-forward (a conv_out GAU in gau mode). In train mode dropout
draws from the caller's ``generator``, and the block's output is blended
with its input by ``alpha = min(0.1 + warmup, 1)``, or 0.1 when layer
drop drops the block (:func:`layer_drop_keep`, one uniform draw a block
a step); at warmup >= 0.9 with no layer drop the blend is an exact
identity. ``warmup`` is a Python number or a 0-dim tensor (the train
step's, on the device).

The ReConformer's block (``re_layer``, JAX :150-345) has no per-branch
norms, adds both feed-forwards at full scale and ends with
``norm_final = BasicNorm(balancer(x))``. ``re_scale`` gives each branch
a learned 0-dim scale, ``use_balancer`` puts balancers in the
feed-forwards and the conv module, and the block norms may be
"layer_norm", "batch_norm" (statistics over B and T, padded frames
included, as the reference's Trans_Bat) or "basic_norm".

The combiners (JAX :347-403, 502-566): the aux taps are
``range(num_blocks // aux_layer_start, num_blocks - 1,
aux_layer_period)`` plus the last block (at the default start of 1 the
range is empty, a kept quirk). "norm" returns the last block, "mfa"
concatenates the taps (``output_dim`` = d x taps), "random_layer" and
"random_frame" (``RandomCombine``) mix them in training with weights
drawn per utterance or per frame (:func:`random_combine_weights`, the
draw; :func:`combine`, the apply) and return the last one in eval.
``after_norm`` exists iff ``normalize_before`` or "mfa" and normalises
the combined output. Chunk masks (mask.py): ``static_chunk_size`` and
``left_chunk_size``, or the dynamic draw in train mode under
``use_dynamic_chunk``.

``TransformerEncoder`` (JAX :570-577): the same stack with defaults
"abs_pos", no macaron, no conv module and relu.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..activations import double_swish
from ..dropout import dropout
from ..norm import BatchNorm, LayerNorm
from .attention import GAU, MultiHeadedAttention, RelPositionMultiHeadedAttention, RoPESelfAttention, T5RelPositionBias
from .convolution import ConvolutionModule
from .embedding import abs_position_encoding
from .mask import add_optional_chunk_mask
from .scaling import BasicNorm, activation_balancer
from .subsampling import make_subsampling

Scalar = Union[float, torch.Tensor]
_ACTIVATIONS = {"relu": torch.relu, "swish": F.silu, "double_swish": double_swish}
_NORM_OPTIONS = ("norm_method", "scale_adapt", "g_sa", "diag_mask", "train_len")
POSITIONS = ("rel_pos", "abs_pos", "rot_pos", "no_pos")
COMBINERS = ("norm", "mfa", "random_layer", "random_frame")


class _TransBatchNorm(BatchNorm):
    """The block norm "batch_norm" on channels-last [B, T, D]: statistics
    over B and T, no mask (the reference's Trans_Bat)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def make_norm(norm_type: str, dim: int) -> nn.Module:
    """A block-level norm over the last axis (JAX encoder.py:34-46)."""
    if norm_type == "batch_norm":
        return _TransBatchNorm(dim, momentum=0.1, epsilon=1e-5)
    if norm_type == "basic_norm":
        return BasicNorm()
    if norm_type != "layer_norm":
        raise ValueError(f"unknown norm_type {norm_type!r}")
    return LayerNorm(dim)


def _activation(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r} (the port has {sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[name]


def _same_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A flax "SAME" conv1d over channels-last x [B, T, C]."""
    k = conv.kernel_size[0]
    h = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    return F.conv1d(h, conv.weight, conv.bias).transpose(1, 2)


class PositionwiseFeedForward(nn.Module):
    """``w1`` -> (balancer) -> activation -> dropout -> ``w2``: Dense and
    Dense ("linear"), conv and conv ("conv1d", MultiLayeredConv1d) or conv
    and Dense ("conv1d-linear", Conv1dLinear); the convs are kernel
    ``kernel_size`` "SAME" over time."""

    def __init__(self, dim: int, hidden_units: int = 2048, dropout_rate: float = 0.1, activation: str = "relu",
                 use_balancer: bool = False, layer_type: str = "linear", kernel_size: int = 1):
        super().__init__()
        if layer_type not in ("linear", "conv1d", "conv1d-linear"):
            raise ValueError(f"unknown positionwise_layer_type {layer_type!r}")
        self.act, self.dropout_rate, self.use_balancer = _activation(activation), dropout_rate, use_balancer
        conv1, conv2 = layer_type != "linear", layer_type == "conv1d"
        self.w1 = nn.Conv1d(dim, hidden_units, kernel_size) if conv1 else nn.Linear(dim, hidden_units)
        self.w2 = nn.Conv1d(hidden_units, dim, kernel_size) if conv2 else nn.Linear(hidden_units, dim)

    @staticmethod
    def _layer(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return _same_conv(layer, x) if isinstance(layer, nn.Conv1d) else layer(x)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self._layer(self.w1, x)
        if self.use_balancer:
            h = activation_balancer(h)
        h = self.act(h)
        if self.dropout_rate > 0 and self.training:
            h = dropout(h, self.dropout_rate, generator)
        return self._layer(self.w2, h)


def _make_attention(dim: int, att_type: str, pos_enc_type: str, heads: int, dropout_rate: float, gau_units: int,
                   gau_key: int, norm_args: Optional[dict] = None, conv_out: bool = False, rotary_value: bool = True,
                   att_conv_out: bool = False) -> nn.Module:
    """JAX encoder.py:116-147: a GAU (RoPE under "rot_pos"; conv_out under
    ``conv_out`` or ``att_conv_out``), else by position the relative, RoPE
    or plain multi-head attention (conv_out under ``att_conv_out`` only).
    ``norm_args`` holds the normalisation's options."""
    kw = {k: v for k, v in dict(norm_args or {}).items() if k in _NORM_OPTIONS}
    if att_type == "gau":
        return GAU(dim, gau_units, gau_key, dropout_rate, use_rope=pos_enc_type == "rot_pos",
                   conv_out=conv_out or att_conv_out, **kw)
    if att_type != "multi":
        raise ValueError(f"unknown att_type {att_type!r}")
    if pos_enc_type == "rel_pos":
        return RelPositionMultiHeadedAttention(dim, heads, dropout_rate, conv_out=att_conv_out, **kw)
    if pos_enc_type == "rot_pos":
        return RoPESelfAttention(dim, heads, dropout_rate, rotary_value=rotary_value, conv_out=att_conv_out, **kw)
    return MultiHeadedAttention(dim, heads, dropout_rate, conv_out=att_conv_out, **kw)


def layer_drop_keep(generator: Optional[torch.Generator], rate: float, device: torch.device) -> torch.Tensor:
    """Layer drop's draw: keep the block (a 0-dim bool on ``device``) with
    probability 1 - rate (JAX encoder.py:206-216)."""
    return torch.rand((), generator=generator, device=device) <= 1.0 - rate


class ConformerBlock(nn.Module):
    """One Conformer (or Transformer) layer; see the module's docstring."""

    def __init__(self, dim: int, attention_heads: int = 4, linear_units: int = 2048, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, pos_enc_type: str = "rel_pos", att_type: str = "multi",
                 gau_units: int = 512, gau_key: int = 64, add_t5rel_bias: bool = False,
                 attention_norm_args: Optional[dict] = None, macaron: bool = True, use_cnn: bool = True,
                 cnn_kernel: int = 15, normalize_before: bool = True, concat_after: bool = False,
                 rotary_value: bool = True, attention_conv_out: bool = False,
                 positionwise_layer_type: str = "linear", positionwise_conv_kernel_size: int = 1,
                 activation_type: str = "swish", cnn_norm_type: str = "layer_norm", norm_type: str = "layer_norm",
                 use_balancer: bool = False, re_scale: bool = False, causal_conv: bool = False,
                 convfnn: bool = False, layer_dropout: float = 0.0, re_layer: bool = False):
        super().__init__()
        self.dropout_rate, self.re_layer, self.re_scale = dropout_rate, re_layer, re_scale
        self.macaron, self.use_cnn, self.concat_after = macaron, use_cnn, concat_after
        self.pre = normalize_before and not re_layer
        self.post = not normalize_before and not re_layer
        self.layer_dropout = layer_dropout
        # the ReConformer's layer adds the macaron feed-forward at full scale
        self.ff_scale = 0.5 if macaron and not re_layer else 1.0
        pw_type = positionwise_layer_type
        if convfnn and pw_type != "gau":
            pw_type = "conv1d"

        def feed_forward():
            if pw_type == "gau":
                kw = {k: v for k, v in dict(attention_norm_args or {}).items() if k in _NORM_OPTIONS}
                return GAU(dim, linear_units, 64, dropout_rate, use_rope=pos_enc_type == "rot_pos",
                           conv_out=convfnn, **kw)
            return PositionwiseFeedForward(dim, linear_units, dropout_rate, activation_type, use_balancer, pw_type,
                                           positionwise_conv_kernel_size)

        branches = {}
        if macaron:
            branches["ff_macaron"] = ("ff_macaron", feed_forward)
        branches["mha"] = ("self_attn", lambda: _make_attention(
            dim, att_type, pos_enc_type, attention_heads, attention_dropout_rate, gau_units, gau_key,
            attention_norm_args, conv_out=convfnn, rotary_value=rotary_value, att_conv_out=attention_conv_out))
        if use_cnn:
            branches["conv"] = ("conv_module", lambda: ConvolutionModule(
                dim, cnn_kernel, cnn_norm_type, causal=causal_conv, use_balancer=use_balancer, re_module=re_layer,
                activation=activation_type))
        branches["ff"] = ("ff", feed_forward)
        for name, (module, build) in branches.items():
            if not re_layer:
                self.add_module(f"norm_{name}", make_norm(norm_type, dim))
            self.add_module(module, build())
            if re_scale and not (name == "mha" and concat_after):
                self.register_parameter(f"scale_{name}", nn.Parameter(torch.ones(())))
        self.t5_bias = T5RelPositionBias() if add_t5rel_bias else None
        if concat_after:
            self.concat_linear = nn.Linear(2 * dim, dim)
        if re_layer:
            self.norm_final = BasicNorm()
        elif use_cnn and normalize_before:
            self.norm_final = make_norm(norm_type, dim)
        else:
            self.norm_final = None

    def _drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.dropout_rate > 0 and self.training:
            return dropout(h, self.dropout_rate, generator)
        return h

    def _branch(self, name: str, x: torch.Tensor, h: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
        """x + scale_<name> * scale * h (JAX's ``res + res_scale * ff_scale * drop(h)``),
        then the post-norm."""
        if self.re_scale:
            x = x + getattr(self, f"scale_{name}") * scale * h
        else:
            x = x + scale * h if scale != 1.0 else x + h
        return getattr(self, f"norm_{name}")(x) if self.post else x

    def _pre_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"norm_{name}")(x) if self.pre else x

    def forward(self, x: torch.Tensor, att_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None, warmup: Scalar = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_orig = x
        if self.macaron:
            h = self.ff_macaron(self._pre_norm("ff_macaron", x), att_mask, generator)
            x = self._branch("ff_macaron", x, self._drop(h, generator), self.ff_scale)
        h = self._pre_norm("mha", x)
        extra = None if self.t5_bias is None else self.t5_bias(x.shape[1], x.device)
        h_att = self.self_attn(h, att_mask, generator, extra)
        if self.concat_after:
            x = x + self.concat_linear(torch.cat([h, h_att], dim=-1))
            x = self.norm_mha(x) if self.post else x
        else:
            x = self._branch("mha", x, self._drop(h_att, generator))
        if self.use_cnn:
            h = self.conv_module(self._pre_norm("conv", x), pad_mask)
            x = self._branch("conv", x, self._drop(h, generator))
        h = self.ff(self._pre_norm("ff", x), att_mask, generator)
        x = self._branch("ff", x, self._drop(h, generator), self.ff_scale)
        if self.norm_final is not None:
            x = self.norm_final(activation_balancer(x) if self.re_layer else x)
        if self.training:
            if isinstance(warmup, torch.Tensor):
                alpha = torch.clamp_max(0.1 + warmup, 1.0)
            else:
                alpha = min(0.1 + warmup, 1.0)
            if self.layer_dropout > 0:
                keep = layer_drop_keep(generator, self.layer_dropout, x.device)
                keep = keep.to(torch.promote_types(x.dtype, torch.float32))
                alpha = keep * alpha + (1.0 - keep) * 0.1
            x = alpha * x + (1.0 - alpha) * x_orig
        return x


def random_combine_weights(generator: Optional[torch.Generator], num: int, n: int, device: torch.device,
                           final_weight: float = 0.5, pure_prob: float = 0.333, stddev: float = 2.0) -> torch.Tensor:
    """RandomCombine's draw (JAX encoder.py:347-403): [num, n] float32
    weights over n layers, drawn on ``device``. With probability
    ``pure_prob`` a row is one-hot (the last layer with probability
    ``final_weight``, else a uniform earlier one), else the softmax of
    N(0, stddev) log-weights with log(final_weight / (1 - final_weight) *
    (n - 1)) added to the last."""

    def pure():
        nonfinal = torch.randint(0, n - 1, (num,), generator=generator, device=device)
        final = torch.rand((num,), generator=generator, device=device) < final_weight
        idx = torch.where(final, n - 1, nonfinal)
        return (idx[:, None] == torch.arange(n, device=device)).to(torch.float32)

    def mixed():
        logprobs = torch.randn((num, n), generator=generator, device=device) * stddev
        logprobs[:, -1] += float(np.log(final_weight / (1.0 - final_weight) * (n - 1)))
        return torch.softmax(logprobs, dim=1)

    if pure_prob <= 0.0:
        return mixed()
    if pure_prob >= 1.0:
        return pure()
    p, m = pure(), mixed()
    return torch.where(torch.rand((num, 1), generator=generator, device=device) < pure_prob, p, m)


def combine(weights: torch.Tensor, outputs: Sequence[torch.Tensor], combiner_type: str) -> torch.Tensor:
    """RandomCombine's apply: the layer outputs [B, T, D] each mixed by
    weights [B, n] ("random_layer") or [B * T, n] ("random_frame")."""
    stacked = torch.stack(list(outputs), dim=-1)  # [B, T, D, n]
    w = weights.to(stacked.dtype)
    b, t = stacked.shape[:2]
    w = w.view(b, t, 1, -1) if combiner_type == "random_frame" else w.view(b, 1, 1, -1)
    return (stacked * w).sum(-1)


class RandomCombine(nn.Module):
    """Mixes the aux layers' outputs in training (the draw, then the
    apply); returns the last one in eval or when there is one."""

    def __init__(self, combiner_type: str = "random_layer", final_weight: float = 0.5, pure_prob: float = 0.333,
                 stddev: float = 2.0):
        super().__init__()
        self.combiner_type, self.final_weight, self.pure_prob, self.stddev = (combiner_type, final_weight,
                                                                              pure_prob, stddev)

    def forward(self, outputs: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = len(outputs)
        if not self.training or n == 1:
            return outputs[-1]
        b, t = outputs[0].shape[:2]
        num = b * t if self.combiner_type == "random_frame" else b
        w = random_combine_weights(generator, num, n, outputs[0].device, self.final_weight, self.pure_prob,
                                   self.stddev)
        return combine(w, outputs, self.combiner_type)


def aux_layers(num_blocks: int, aux_layer_period: int, aux_layer_start: int) -> List[int]:
    """The blocks whose outputs the combiner takes (JAX encoder.py:502-515)."""
    return list(range(num_blocks // aux_layer_start, num_blocks - 1, aux_layer_period)) + [num_blocks - 1]


class ConformerEncoder(nn.Module):
    """The stack: ``forward(x [B, T, F], mask [B, T])`` -> (``[B, T',
    output_dim]``, the subsampled mask or None)."""

    def __init__(self, input_dim: int = 80, attention_dim: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, layer_dropout: float = 0.0, input_layer: str = "conv2d",
                 pos_enc_type: str = "rel_pos", att_type: str = "multi", gau_units: int = 512, gau_key: int = 64,
                 add_t5rel_bias: bool = False, attention_norm_args: Optional[dict] = None, macaron: bool = True,
                 use_cnn: bool = True, cnn_kernel: int = 15, cnn_norm_type: str = "layer_norm",
                 normalize_before: bool = True, positionwise_layer_type: str = "linear",
                 positionwise_conv_kernel_size: int = 1, convfnn_blocks: int = 0, activation_type: str = "swish",
                 combiner_type: str = "norm", aux_layer_period: int = 3, aux_layer_start: int = 1,
                 static_chunk_size: int = 0, left_chunk_size: int = -1, use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False, concat_after: bool = False, rotary_value: bool = True,
                 rope_abs_plus: bool = False, attention_conv_out: bool = False, re_scale: bool = False,
                 re_layer: bool = False, norm_type: str = "layer_norm", use_balancer: bool = False):
        super().__init__()
        if pos_enc_type not in POSITIONS:
            raise ValueError(f"unknown pos_enc_type {pos_enc_type!r}")
        if combiner_type not in COMBINERS:
            raise ValueError(f"unknown combiner_type {combiner_type!r}")
        self.attention_dim, self.pos_enc_type, self.rope_abs_plus = attention_dim, pos_enc_type, rope_abs_plus
        self.chunk = dict(static_chunk_size=static_chunk_size, num_left_chunks=left_chunk_size,
                          use_dynamic_chunk=use_dynamic_chunk, use_dynamic_left_chunk=use_dynamic_left_chunk)
        self.combiner_type = combiner_type
        self.embed = make_subsampling(input_layer, input_dim, attention_dim, dropout_rate)
        self.blocks = []
        for i in range(num_blocks):
            block = ConformerBlock(
                attention_dim, attention_heads=attention_heads, linear_units=linear_units,
                dropout_rate=dropout_rate, attention_dropout_rate=attention_dropout_rate, pos_enc_type=pos_enc_type,
                att_type=att_type, gau_units=gau_units, gau_key=gau_key, add_t5rel_bias=add_t5rel_bias,
                attention_norm_args=attention_norm_args, macaron=macaron, use_cnn=use_cnn, cnn_kernel=cnn_kernel,
                normalize_before=normalize_before, concat_after=concat_after, rotary_value=rotary_value,
                attention_conv_out=attention_conv_out, positionwise_layer_type=positionwise_layer_type,
                positionwise_conv_kernel_size=positionwise_conv_kernel_size, activation_type=activation_type,
                cnn_norm_type=cnn_norm_type, norm_type=norm_type, use_balancer=use_balancer, re_scale=re_scale,
                causal_conv=static_chunk_size > 0, convfnn=i < convfnn_blocks, layer_dropout=layer_dropout,
                re_layer=re_layer)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.aux_layers = aux_layers(num_blocks, aux_layer_period, aux_layer_start)
        self.output_dim = attention_dim * (len(self.aux_layers) if combiner_type == "mfa" else 1)
        if combiner_type in ("random_layer", "random_frame"):
            self.combiner = RandomCombine(combiner_type)
        # after_norm exists iff normalize_before or mfa (JAX encoder.py:562-566)
        has_after = normalize_before or combiner_type == "mfa"
        self.after_norm = make_norm(norm_type, self.output_dim) if has_after else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, warmup: Scalar = 1.0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h, mask = self.embed(x, mask, generator)
        if self.pos_enc_type == "abs_pos" or (self.pos_enc_type == "rot_pos" and self.rope_abs_plus):
            h = abs_position_encoding(h)
        elif self.pos_enc_type in ("rel_pos", "rot_pos"):
            h = h * math.sqrt(self.attention_dim)
        att_mask = add_optional_chunk_mask(mask, h.shape[1], draw=self.training, generator=generator,
                                           device=h.device, **self.chunk)
        taps = []
        for i, block in enumerate(self.blocks):
            h = block(h, att_mask, mask, warmup, generator)
            if i in self.aux_layers:
                taps.append(h)
        if self.combiner_type == "mfa":
            h = torch.cat(taps, dim=-1)
        elif self.combiner_type != "norm":
            h = self.combiner(taps, generator)
        return (h if self.after_norm is None else self.after_norm(h)), mask


class TransformerEncoder(ConformerEncoder):
    """The plain Transformer stack: "abs_pos", no macaron, no conv module,
    relu (each overridable)."""

    def __init__(self, input_dim: int = 80, pos_enc_type: str = "abs_pos", macaron: bool = False,
                 use_cnn: bool = False, activation_type: str = "relu", **kwargs: Any):
        super().__init__(input_dim, pos_enc_type=pos_enc_type, macaron=macaron, use_cnn=use_cnn,
                         activation_type=activation_type, **kwargs)
