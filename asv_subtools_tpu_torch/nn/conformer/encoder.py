"""Conformer encoder (counterpart: asv_subtools_tpu/nn/conformer/encoder.py:52-567).

``[B, T, F]`` features (+ a ``[B, T]`` mask) -> the input subsampling ->
``h * sqrt(d)`` and the position table (rel_pos) -> the blocks ->
``after_norm`` -> ``[B, T', d]`` and the subsampled mask. Channels-last
throughout; module names follow the flax modules.

Each block is the pre-norm macaron Conformer layer: half a feed-forward,
self-attention, the convolution module, half a feed-forward, then
``norm_final``. In train mode dropout draws from the caller's
``generator``, and the block's output is blended with its input by
``alpha = min(0.1 + warmup, 1)`` (JAX encoder.py:210-217, 341-343): at
warmup >= 0.9 the blend is an exact identity. ``warmup`` is a Python
number or a 0-dim tensor (the train step's, on the device).

The ReConformer's block (``re_layer``, JAX encoder.py:150-345) has no
per-branch norms, adds both feed-forwards at full scale and ends with
``norm_final = BasicNorm(balancer(x))``; there ``normalize_before`` is
False and the stack has no ``after_norm``. ``re_scale`` gives each
branch a learned 0-dim scale (``scale_ff_macaron``, ``scale_mha``,
``scale_conv``, ``scale_ff``), ``use_balancer`` puts balancers in the
feed-forwards and the conv module, and the block norms may be
"layer_norm", "batch_norm" (statistics over B and T, padded frames
included, as the reference's Trans_Bat) or "basic_norm".

Ported: pos_enc_type "rel_pos"; att_type "multi"; the macaron
"linear" feed-forwards with swish, relu or double_swish and the
convolution module; combiner_type "norm"; the options above. Raising
``NotImplementedError`` (ROADMAP Queue 1 item 3): the other positions
("abs_pos", "rot_pos", "no_pos"), GAU, the T5 bias and the attention
norm options (attention.py), blocks without macaron or without the conv
module, layer_dropout, convfnn_blocks, concat_after, the post-norm
Conformer (normalize_before=False without re_layer), the conv
feed-forwards, the "mfa" and random combiners, chunk masks and the
TransformerEncoder.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..activations import double_swish
from ..dropout import dropout
from ..norm import BatchNorm, LayerNorm
from .attention import RelPositionMultiHeadedAttention
from .convolution import ConvolutionModule
from .mask import add_optional_chunk_mask
from .scaling import BasicNorm, activation_balancer
from .subsampling import make_subsampling

Scalar = Union[float, torch.Tensor]
_ACTIVATIONS = {"relu": torch.relu, "swish": F.silu, "double_swish": double_swish}
_ITEM = "(ROADMAP Queue 1 item 3)"


def _not_ported(what: str, options: dict) -> None:
    """Raise for the first option that differs from its ported value."""
    for name, (value, ported) in options.items():
        if value != ported:
            raise NotImplementedError(f"{what} option {name}={value!r} is not ported yet {_ITEM}")


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


class PositionwiseFeedForward(nn.Module):
    """Dense -> (balancer) -> activation -> dropout -> Dense."""

    def __init__(self, dim: int, hidden_units: int = 2048, dropout_rate: float = 0.1, activation: str = "relu",
                 use_balancer: bool = False):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise NotImplementedError(f"activation {activation!r} is not ported yet {_ITEM}")
        self.act, self.dropout_rate, self.use_balancer = _ACTIVATIONS[activation], dropout_rate, use_balancer
        self.w1 = nn.Linear(dim, hidden_units)
        self.w2 = nn.Linear(hidden_units, dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.w1(x)
        if self.use_balancer:
            h = activation_balancer(h)
        h = self.act(h)
        if self.dropout_rate > 0 and self.training:
            h = dropout(h, self.dropout_rate, generator)
        return self.w2(h)


class ConformerBlock(nn.Module):
    """One macaron Conformer layer: 0.5 FF -> relative-position MHA ->
    conv module -> 0.5 FF -> norm_final, pre-norm; or the ReConformer's
    layer (``re_layer``)."""

    def __init__(self, dim: int, attention_heads: int = 4, linear_units: int = 2048, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, pos_enc_type: str = "rel_pos", att_type: str = "multi",
                 add_t5rel_bias: bool = False, attention_norm_args: Optional[dict] = None, macaron: bool = True,
                 use_cnn: bool = True, cnn_kernel: int = 15, normalize_before: bool = True,
                 concat_after: bool = False, attention_conv_out: bool = False,
                 positionwise_layer_type: str = "linear", activation_type: str = "swish",
                 cnn_norm_type: str = "layer_norm", norm_type: str = "layer_norm", use_balancer: bool = False,
                 re_scale: bool = False, causal_conv: bool = False, convfnn: bool = False,
                 layer_dropout: float = 0.0, re_layer: bool = False):
        super().__init__()
        _not_ported("ConformerBlock", {
            "att_type": (att_type, "multi"), "add_t5rel_bias": (add_t5rel_bias, False),
            "normalize_before": (normalize_before or re_layer, True), "concat_after": (concat_after, False),
            "positionwise_layer_type": (positionwise_layer_type, "linear"), "causal_conv": (causal_conv, False),
            "convfnn": (convfnn, False), "layer_dropout": (layer_dropout, 0.0), "macaron": (macaron, True),
            "use_cnn": (use_cnn, True), "pos_enc_type": (pos_enc_type, "rel_pos")})
        self.dropout_rate, self.re_layer, self.re_scale = dropout_rate, re_layer, re_scale
        # the ReConformer's layer adds both feed-forwards at full scale
        self.ff_scale = 1.0 if re_layer else 0.5
        ff = dict(hidden_units=linear_units, dropout_rate=dropout_rate, activation=activation_type,
                  use_balancer=use_balancer)
        branches = {
            "ff_macaron": lambda: PositionwiseFeedForward(dim, **ff),
            "mha": lambda: RelPositionMultiHeadedAttention(dim, attention_heads, attention_dropout_rate,
                                                           conv_out=attention_conv_out, **(attention_norm_args or {})),
            "conv": lambda: ConvolutionModule(dim, cnn_kernel, cnn_norm_type, use_balancer=use_balancer,
                                              re_module=re_layer, activation=activation_type),
            "ff": lambda: PositionwiseFeedForward(dim, **ff)}
        modules = {"ff_macaron": "ff_macaron", "mha": "self_attn", "conv": "conv_module", "ff": "ff"}
        for name, build in branches.items():
            if not re_layer:
                self.add_module(f"norm_{name}", make_norm(norm_type, dim))
            self.add_module(modules[name], build())
        self.norm_final = BasicNorm() if re_layer else make_norm(norm_type, dim)
        if re_scale:
            for name in branches:
                self.register_parameter(f"scale_{name}", nn.Parameter(torch.ones(())))

    def _drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.dropout_rate > 0 and self.training:
            return dropout(h, self.dropout_rate, generator)
        return h

    def _branch(self, name: str, x: torch.Tensor, h: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
        """x + scale_<name> * scale * h (JAX's ``res + res_scale * ff_scale * drop(h)``)."""
        if self.re_scale:
            return x + getattr(self, f"scale_{name}") * scale * h
        return x + scale * h if scale != 1.0 else x + h

    def _pre_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x if self.re_layer else getattr(self, f"norm_{name}")(x)

    def forward(self, x: torch.Tensor, att_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None, warmup: Scalar = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_orig = x
        h = self.ff_macaron(self._pre_norm("ff_macaron", x), generator)
        x = self._branch("ff_macaron", x, self._drop(h, generator), self.ff_scale)
        h = self.self_attn(self._pre_norm("mha", x), att_mask, generator)
        x = self._branch("mha", x, self._drop(h, generator))
        h = self.conv_module(self._pre_norm("conv", x), pad_mask)
        x = self._branch("conv", x, self._drop(h, generator))
        h = self.ff(self._pre_norm("ff", x), generator)
        x = self._branch("ff", x, self._drop(h, generator), self.ff_scale)
        x = self.norm_final(activation_balancer(x) if self.re_layer else x)
        if self.training:
            if isinstance(warmup, torch.Tensor):
                alpha = torch.clamp_max(0.1 + warmup, 1.0)
            else:
                alpha = min(0.1 + warmup, 1.0)
            x = alpha * x + (1.0 - alpha) * x_orig
        return x


class ConformerEncoder(nn.Module):
    """The Conformer stack: ``forward(x [B, T, F], mask [B, T])`` ->
    (``[B, T', attention_dim]``, the subsampled mask or None)."""

    def __init__(self, input_dim: int = 80, attention_dim: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, layer_dropout: float = 0.0, input_layer: str = "conv2d",
                 pos_enc_type: str = "rel_pos", att_type: str = "multi", add_t5rel_bias: bool = False,
                 attention_norm_args: Optional[dict] = None, macaron: bool = True, use_cnn: bool = True,
                 cnn_kernel: int = 15, cnn_norm_type: str = "layer_norm", normalize_before: bool = True,
                 positionwise_layer_type: str = "linear", convfnn_blocks: int = 0, activation_type: str = "swish",
                 combiner_type: str = "norm", static_chunk_size: int = 0, use_dynamic_chunk: bool = False,
                 concat_after: bool = False, attention_conv_out: bool = False, re_scale: bool = False,
                 re_layer: bool = False, norm_type: str = "layer_norm", use_balancer: bool = False,
                 positionwise_conv_kernel_size: int = 1, **unported: Any):
        """``positionwise_conv_kernel_size`` belongs to the conv
        feed-forwards, which raise; the ReConformer's defaults set it
        (JAX models/conformer.py:64) for a "linear" feed-forward that
        ignores it."""
        super().__init__()
        if unported:
            raise NotImplementedError(f"ConformerEncoder options {sorted(unported)} are not ported yet {_ITEM}")
        if combiner_type != "norm":
            raise NotImplementedError(f"combiner_type {combiner_type!r} is not ported yet {_ITEM}")
        if static_chunk_size > 0 or use_dynamic_chunk:
            raise NotImplementedError(f"chunk masks (static_chunk_size, use_dynamic_chunk) are not ported yet {_ITEM}")
        _not_ported("ConformerEncoder", {"convfnn_blocks": (convfnn_blocks, 0)})
        self.attention_dim = attention_dim
        self.embed = make_subsampling(input_layer, input_dim, attention_dim)
        self.blocks = []
        for i in range(num_blocks):
            block = ConformerBlock(
                attention_dim, attention_heads=attention_heads, linear_units=linear_units,
                dropout_rate=dropout_rate, attention_dropout_rate=attention_dropout_rate, pos_enc_type=pos_enc_type,
                att_type=att_type, add_t5rel_bias=add_t5rel_bias, attention_norm_args=attention_norm_args,
                macaron=macaron, use_cnn=use_cnn, cnn_kernel=cnn_kernel, normalize_before=normalize_before,
                concat_after=concat_after, attention_conv_out=attention_conv_out,
                positionwise_layer_type=positionwise_layer_type, activation_type=activation_type,
                cnn_norm_type=cnn_norm_type, norm_type=norm_type, use_balancer=use_balancer, re_scale=re_scale,
                layer_dropout=layer_dropout, re_layer=re_layer)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        # after_norm exists iff normalize_before (JAX encoder.py:562-566)
        self.after_norm = make_norm(norm_type, attention_dim) if normalize_before else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, warmup: Scalar = 1.0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h, mask = self.embed(x, mask)
        # wenet's RelPositionalEncoding scales by sqrt(d); the attention
        # builds the table of positions 0..T'-1 itself
        h = h * math.sqrt(self.attention_dim)
        att_mask = add_optional_chunk_mask(mask, h.shape[1])
        for block in self.blocks:
            h = block(h, att_mask, mask, warmup, generator)
        return (h if self.after_norm is None else self.after_norm(h)), mask


def TransformerEncoder(*args, **kwargs):
    raise NotImplementedError(f"TransformerEncoder is not ported yet {_ITEM}")
