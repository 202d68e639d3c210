"""The TDNN x-vector family (counterpart: asv_subtools_tpu/models/xvector.py).

``Xvector`` (five TDNN layers), ``SnowdarXvector`` (extend, skip
connection, SE blocks, dropout), ``ExtendedXvector`` (the E-TDNN) and
``FactoredXvector`` (the F-TDNN, whose ``factor1`` weights the train step
keeps semi-orthogonal with ``TrainStepConfig.use_semi_orth``). Each maps
``[B, T, D]`` (and a ``[B, T]`` mask) to ``[B, embd_dim]``; ``position``
picks the embedding: "far" (the first embedding affine), "near_affine"
(the second affine) or "near" (after its relu and BN, the default).

The model transposes its input once to ``[B, C, T]`` and hands the
pooling a ``[B, T, C]`` view of the last frame layer (no copy; the fused
statistics pooling makes the one copy it needs). Module names follow the
flax modules (``tdnn1`` .. ``tdnn7_bn``, ``ex_tdnn1`` .. ``ex_tdnn5``,
``se1`` .. ``se4``, ``layer01`` .. ``layer10``, ``embed1_*``), so
weights.py maps a JAX variable tree onto the state_dict by rule. The BN
defaults are the JAX models': momentum 0.5 and no BN affine for the
snowdar family, momentum 0.1 with affine BNs for the F-TDNN.

Built on ``device`` (the CUDA card unless ``device="cpu"``; raises without
a card), in eval mode. ``pooling_params={"fused_inference": True}`` runs
the statistics pooling through its fused kernel at inference.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn.dropout import dropout
from ..nn.norm import BatchNorm
from ..nn.pooling import build_pooling
from ..nn.tdnn import FTdnnBlock, ReluBatchNormTdnnLayer, SEBlock

_POSITIONS = ("near", "near_affine", "far")


def _check_position(position: str) -> None:
    if position not in _POSITIONS:
        raise ValueError(f"position must be near, near_affine or far, got {position!r}")


def build_snowdar_trunk(module: nn.Module, input_dim: int, channels: int, *, extend: bool, skip_connection: bool,
                        se_block: bool, se_ratio: int, momentum: float, bn_affine: bool) -> None:
    """Add the snowdar frame-level trunk, tdnn1 .. tdnn4, to ``module``
    under the flax names (JAX models/xvector.py:90 ``snowdar_trunk``, which
    scopes its layers into the calling model): ``extend`` interleaves the
    E-TDNN 1x1 layers ``ex_tdnn1`` .. ``ex_tdnn5``; ``se_block`` puts SE
    blocks ``se1`` .. ``se3`` after tdnn1-3 (and ``se4`` after ex_tdnn4 when
    extended); ``skip_connection`` adds tdnn1's output (before its SE) to
    tdnn4's once. Shared by SnowdarXvector, MultiTaskXvector and FDXvector."""
    plan = [("tdnn1", (-2, -1, 0, 1, 2), "se1")]
    if extend:
        plan += [("ex_tdnn1", (0,), None)]
    plan += [("tdnn2", (-2, 0, 2), "se2")]
    if extend:
        plan += [("ex_tdnn2", (0,), None)]
    plan += [("tdnn3", (-3, 0, 3), "se3")]
    if extend:
        plan += [("ex_tdnn3", (0,), None), ("ex_tdnn4", (-4, 0, 4), "se4"), ("ex_tdnn5", (0,), None)]
    plan += [("tdnn4", (0,), None)]
    module.skip_connection = skip_connection
    module._plan = []
    in_dim = input_dim
    for name, ctx, se_name in plan:
        module.add_module(name, ReluBatchNormTdnnLayer(in_dim, channels, ctx, momentum, bn_affine=bn_affine))
        in_dim = channels
        se = se_name if se_block else None
        if se is not None:
            module.add_module(se, SEBlock(channels, ratio=se_ratio))
        module._plan.append((name, se))


def snowdar_trunk(module: nn.Module, h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The trunk :func:`build_snowdar_trunk` added to ``module``: h [B, D, T]
    -> [B, C, T]."""
    identity = None
    for name, se in module._plan:
        h = getattr(module, name)(h, mask)
        if module.skip_connection and name == "tdnn1":
            identity = h
        if module.skip_connection and name == "tdnn4":
            h = h + identity
        if se is not None:
            h = getattr(module, se)(h, mask)
    return h


class _TwoEmbeddings(nn.Module):
    """pooling -> affine [far] -> relu, BN -> affine [near_affine] -> relu,
    BN [near], with the two layers named ``<first>_affine``/``<first>_bn``
    and ``<second>_*``. The BNs take no mask."""

    def _build_head(self, frame_dim: int, embd_dim: int, pooling: str, pooling_params: Optional[dict],
                    names: tuple, **bn_kw: Any) -> None:
        self.embd_dim = embd_dim
        self._names = names
        self.stats = build_pooling(pooling, frame_dim, pooling_params)
        stats_dim = self.stats.output_dim(frame_dim)
        first, second = names
        self.add_module(f"{first}_affine", nn.Linear(stats_dim, embd_dim))
        self.add_module(f"{first}_bn", BatchNorm(embd_dim, **bn_kw))
        self.add_module(f"{second}_affine", nn.Linear(embd_dim, embd_dim))
        self.add_module(f"{second}_bn", BatchNorm(embd_dim, **bn_kw))

    def _head(self, h: torch.Tensor, mask: Optional[torch.Tensor], position: str) -> torch.Tensor:
        """h [B, C, T] -> the embedding at ``position``."""
        first, second = self._names
        z = getattr(self, f"{first}_affine")(self.stats(h.transpose(1, 2), mask))
        if position == "far":
            return z
        z = getattr(self, f"{second}_affine")(getattr(self, f"{first}_bn")(torch.relu(z)))
        if position == "near_affine":
            return z
        return getattr(self, f"{second}_bn")(torch.relu(z))


class Xvector(_TwoEmbeddings):
    """The plain five-layer TDNN x-vector: contexts [-2..2], [-2, 0, 2],
    [-3, 0, 3], [0], [0] (the last 1500 wide), statistics pooling, two
    embedding layers (``tdnn6``, ``tdnn7``). ``bn_affine=True`` and
    ``momentum=0.1`` give the older xvector.py flavour."""

    def __init__(self, input_dim: int = 80, num_frame_channels: int = 512, embd_dim: int = 512,
                 pooling: str = "statistics", pooling_params: Optional[dict] = None, momentum: float = 0.5,
                 bn_affine: bool = False, device: Any = None):
        super().__init__()
        c = num_frame_channels
        contexts = [(-2, -1, 0, 1, 2), (-2, 0, 2), (-3, 0, 3), (0,), (0,)]
        dims = [input_dim, c, c, c, c, 1500]
        for i, ctx in enumerate(contexts):
            self.add_module(f"tdnn{i + 1}", ReluBatchNormTdnnLayer(dims[i], dims[i + 1], ctx, momentum,
                                                                  bn_affine=bn_affine))
        self._build_head(1500, embd_dim, pooling, pooling_params, ("tdnn6", "tdnn7"), momentum=momentum,
                         use_scale=bn_affine, use_bias=bn_affine)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near") -> torch.Tensor:
        """x [B, T, D] (channels-last), mask [B, T] -> embedding [B, embd_dim]."""
        _check_position(position)
        h = x.transpose(1, 2)
        for i in range(5):
            h = getattr(self, f"tdnn{i + 1}")(h, mask)
        return self._head(h, mask, position)


class SnowdarXvector(_TwoEmbeddings):
    """The standard or extended x-vector with the full switchboard:
    ``extend`` interleaves the E-TDNN 1x1 layers (``ex_tdnn1`` ..
    ``ex_tdnn5``); ``skip_connection`` adds tdnn1's output (before its SE)
    to tdnn4's once; ``se_block`` puts SE blocks ``se1`` .. ``se3`` after
    tdnn1-3 (and ``se4`` after ex_tdnn4 when extended); ``aug_dropout``
    on the input and ``tail_dropout`` on the embedding act in train mode,
    drawn from the step's generator."""

    def __init__(self, input_dim: int = 80, num_frame_channels: int = 512, embd_dim: int = 512,
                 extend: bool = False, skip_connection: bool = False, se_block: bool = False, se_ratio: int = 4,
                 pooling: str = "statistics", pooling_params: Optional[dict] = None, aug_dropout: float = 0.0,
                 tail_dropout: float = 0.0, training_stage: bool = True, momentum: float = 0.5,
                 bn_affine: bool = False, device: Any = None):
        super().__init__()
        c = num_frame_channels
        self.aug_dropout, self.tail_dropout = aug_dropout, tail_dropout
        build_snowdar_trunk(self, input_dim, c, extend=extend, skip_connection=skip_connection, se_block=se_block,
                            se_ratio=se_ratio, momentum=momentum, bn_affine=bn_affine)
        self.tdnn5 = ReluBatchNormTdnnLayer(c, 1500, (0,), momentum, bn_affine=bn_affine)
        self._build_head(1500, embd_dim, pooling, pooling_params, ("tdnn6", "tdnn7"), momentum=momentum,
                         use_scale=bn_affine, use_bias=bn_affine)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, D] (channels-last), mask [B, T] -> embedding [B, embd_dim].
        ``generator`` draws the dropout masks in train mode."""
        _check_position(position)
        if self.aug_dropout > 0 and self.training:
            x = dropout(x, self.aug_dropout, generator)
        z = self._head(self.tdnn5(snowdar_trunk(self, x.transpose(1, 2), mask), mask), mask, position)
        if position == "near" and self.tail_dropout > 0 and self.training:
            z = dropout(z, self.tail_dropout, generator)
        return z


class ExtendedXvector(SnowdarXvector):
    """The E-TDNN x-vector: SnowdarXvector with ``extend=True``."""

    def __init__(self, *args: Any, extend: bool = True, **kwargs: Any):
        super().__init__(*args, extend=extend, **kwargs)


class FactoredXvector(_TwoEmbeddings):
    """The F-TDNN x-vector: ``layer01`` (5-tap), ``layer02`` .. ``layer09``
    FTdnnBlocks with the reference's (context, bypass) plan and two concat
    skips (layer07 <- [x2; x4], layer09 <- [x4; x6; x8]), ``layer10``,
    pooling, ``embed1``, ``embed2``. ``width`` scales every hidden width
    (1.0: 512, 1024, bottleneck 256, 2048)."""

    # (name, input, context, bypass): the input is one layer's output or a concat
    _PLAN = (("layer02", ("x1",), 2, 0.0), ("layer03", ("x2",), 0, 0.66), ("layer04", ("x3",), 3, 0.66),
             ("layer05", ("x3",), 0, 0.66), ("layer06", ("x5",), 3, 0.66), ("layer07", ("x2", "x4"), 3, 0.0),
             ("layer08", ("x7",), 3, 0.66), ("layer09", ("x4", "x6", "x8"), 0, 0.0))

    def __init__(self, input_dim: int = 80, width: float = 1.0, embd_dim: int = 512, pooling: str = "statistics",
                 pooling_params: Optional[dict] = None, momentum: float = 0.1, device: Any = None):
        super().__init__()
        frame, block, bneck, final = int(512 * width), int(1024 * width), int(256 * width), int(2048 * width)
        self.layer01 = ReluBatchNormTdnnLayer(input_dim, frame, (-2, -1, 0, 1, 2), momentum)
        for name, inputs, ctx, bypass in self._PLAN:
            in_dim = frame if inputs == ("x1",) else block * len(inputs)
            self.add_module(name, FTdnnBlock(in_dim, block, bneck, context_size=ctx, bypass_scale=bypass,
                                             momentum=momentum))
        self.layer10 = ReluBatchNormTdnnLayer(block, final, (0,), momentum)
        self._build_head(final, embd_dim, pooling, pooling_params, ("embed1", "embed2"), momentum=momentum)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near") -> torch.Tensor:
        """x [B, T, D] (channels-last), mask [B, T] -> embedding [B, embd_dim]."""
        _check_position(position)
        xs = {"x1": self.layer01(x.transpose(1, 2), mask)}
        for name, inputs, _, _ in self._PLAN:
            h = xs[inputs[0]] if len(inputs) == 1 else torch.cat([xs[k] for k in inputs], dim=1)
            xs["x" + name[-1]] = getattr(self, name)(h, mask)
        return self._head(self.layer10(xs["x9"], mask), mask, position)
