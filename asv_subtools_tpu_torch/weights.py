"""Carry model weights between a JAX variable tree and the port's state_dict.

The JAX model's variables ``{"params": ..., "batch_stats": ...}`` arrive as
nested dicts of numpy arrays (this module imports nothing of JAX). The
port's modules carry the flax module names, so each leaf maps by rule:

* a flax 1-D Conv ``kernel [k, in, out]`` -> ``<path>.weight [out, in, k]``;
* a flax 2-D Conv ``kernel [kh, kw, in, out]`` -> ``<path>.weight
  [out, in, kh, kw]`` (the port's maps are ``[B, C, T, F]``: H = T, W = F);
* a flax Dense ``kernel [in, out]`` -> ``<path>.weight [out, in]``;
* the ``_SplitGlobalConv`` kernel (module ``att1``, ``[1, 3C, K]``) keeps
  its layout as ``<path>.kernel``. A plain 1x1 conv under the same name
  (``[1, C, K]``, the attentive pooling without time attention) takes the
  1-D conv rule; the two are told apart by the width of the pooling's
  ``att2`` kernel ``[1, K, C]`` beside it;
* ``bias``, BN, LayerNorm and GroupNorm ``scale`` (params) and ``mean``,
  ``var`` (batch_stats) map one to one; so do the margin losses' classifier
  ``loss/weight`` (``[C * sub_k, D]``), the logistic affinity head's
  scalars ``loss/w`` and ``loss/b`` and the one-class head's
  ``loss/center`` (``[1, D]``; these four only directly under a loss
  head: ``loss``, MultiTaskNet's ``loss_spk`` or FD's ``loss2``), the margin losses' ring radius ``ring_r``, the
  curricular statistic ``curricular_t`` (batch_stats), the relative
  attention's ``pos_bias_u`` and ``pos_bias_v`` (``[H, Dh]``), the LDE
  pooling's ``mu`` (``[D, C]``) and ``s``, the xi-vector pooling's
  ``prior_mean`` and ``prior_logprec`` and the attention's learnable
  temperatures ``t``. A grouped 1-D conv kernel ``[k, in/groups, out]``
  and the Conformer's depthwise kernel ``[k, 1, D]`` take the 1-D conv
  rule (``[out, in/groups, k]``); the Dense of a TDNN layer with an
  irregular context (``affine/affine/kernel``, ``[len(ctx) * in, out]``)
  takes the Dense rule; so do the softmax and focal heads'
  ``loss/affine/kernel``. Grouped 2-D kernels ``[kh, kw, in/groups, out]``
  and RepVGG's deployed 5x5 ``reparam`` kernels take the 2-D conv rule.
  A non-affine BatchNorm has no params to map.

A whole train state crosses too (:func:`train_state_from_variables` and
:func:`train_state_to_variables`): the step, the net's params
(``SpeakerNet``, ``MultiTaskNet`` or ``FDSpeakerNet``), the batch_stats
and the optimizer state, whose moment trees (optax's ``mu``, ``nu`` or
``trace``) map by the params' rules; FD's optimizer state is a pair.

Every leaf is consumed exactly once; a leaf no rule takes raises, and
:func:`load_variables` raises on any port parameter left unset. The rules
hold for every ported family (ECAPA-TDNN with any pooling, the lawlict
ECAPA, ResNet and RepVGG x-vectors in train and deploy shape, Conformer
x-vector, the TDNN x-vectors) and every loss head; the ``*ecapa*`` names
are the original ones and stay as aliases.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .nn.loss import LOSSES, MARGIN_LOSSES
from .train.trainer import TrainState

_SPLIT_CONV = "att1"
_ONE_TO_ONE_PARAMS = ("bias", "scale", "ring_r", "pos_bias_u", "pos_bias_v", "mu", "s", "prior_mean",
                      "prior_logprec", "t")
_STATS = ("mean", "var", "curricular_t")
# the loss heads (SpeakerNet's ``loss``, MultiTaskNet's ``loss_spk``,
# FDSpeakerNet's ``loss`` and ``loss2``): a head's "weight" is no Dense
# kernel; these leaves map one to one directly under a head ("b" or "w"
# elsewhere would catch other leaves)
_LOSSES = ("loss", "loss_spk", "loss2")
_LOSS_PARAMS = ("weight", "w", "b", "center")


def _is_loss_param(mods, leaf: str) -> bool:
    return leaf in _LOSS_PARAMS and bool(mods) and mods[-1] in _LOSSES


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = (),
            parent: Optional[Mapping] = None) -> Iterator[Tuple[Tuple[str, ...], np.ndarray, Mapping]]:
    """(path, leaf, the mapping that holds the leaf's module) over a tree."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,), tree)
        else:
            yield prefix + (key,), np.asarray(value), parent or {}


def _is_split_conv(path: Tuple[str, ...], value: np.ndarray, siblings: Mapping) -> bool:
    """An ``att1`` kernel is ``_SplitGlobalConv``'s ``[1, 3C, K]`` when its
    pooling's ``att2`` (``[1, K, C]``) says its input is 3C wide; with C
    wide it is a plain 1x1 conv (the attentive pooling without time
    attention), which takes the 1-D conv rule."""
    if path[-2:] != (_SPLIT_CONV, "kernel") or value.ndim != 3:
        return False
    att2 = np.shape(siblings.get("att2", {}).get("kernel"))
    if len(att2) != 3 or value.shape[1] not in (att2[2], 3 * att2[2]):
        raise ValueError(f"{'/'.join(path)} {value.shape}: no att2 kernel [1, K, C] beside it tells its input")
    return value.shape[1] == 3 * att2[2]


def _to_port(collection: str, path: Tuple[str, ...], value: np.ndarray, siblings: Mapping) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    key = lambda name: ".".join((*mods, name))
    if collection == "batch_stats" and leaf in _STATS:
        return key(leaf), value
    if collection == "params":
        if leaf in _ONE_TO_ONE_PARAMS or _is_loss_param(mods, leaf):
            return key(leaf), value
        if _is_split_conv(path, value, siblings):
            return key("kernel"), value
        if leaf == "kernel" and value.ndim == 4:
            return key("weight"), value.transpose(3, 2, 0, 1)
        if leaf == "kernel" and value.ndim == 3:
            return key("weight"), value.transpose(2, 1, 0)
        if leaf == "kernel" and value.ndim == 2:
            return key("weight"), value.T
    raise ValueError(f"no rule maps {collection}/{'/'.join(path)} {value.shape}")


def variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree (numpy leaves) -> port state_dict."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value, siblings in _leaves(variables.get(collection, {})):
            key, arr = _to_port(collection, path, value, siblings)
            if key in out:
                raise ValueError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(np.array(arr, order="C"))  # a copy; keeps a 0-d leaf 0-d
    return out


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The inverse: port state_dict -> JAX ``{"params", "batch_stats"}`` tree of numpy arrays."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        *mods, leaf = key.split(".")
        value = tensor.detach().cpu().numpy()
        if leaf in _STATS:
            collection, name = "batch_stats", leaf
        elif leaf in _ONE_TO_ONE_PARAMS + ("kernel",) or _is_loss_param(mods, leaf):
            collection, name = "params", leaf
        elif leaf == "weight" and value.ndim == 4:
            collection, name, value = "params", "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and value.ndim == 3:
            collection, name, value = "params", "kernel", value.transpose(2, 1, 0)
        elif leaf == "weight" and value.ndim == 2:
            collection, name, value = "params", "kernel", value.T
        else:
            raise ValueError(f"no rule maps state_dict key {key} {value.shape}")
        node = out[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.array(value, order="C")
    return out


def load_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a JAX variable tree into ``model`` (in place, keeping its device
    and types). Raises on unconsumed leaves, unset parameters and shape
    mismatches."""
    state = variables_to_state_dict(variables)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    if missing or unexpected:
        raise ValueError(f"weights do not match the model: missing {missing}, unconsumed {unexpected}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(expected[key].shape)}")
    model.load_state_dict(
        {k: v.to(device=expected[k].device, dtype=expected[k].dtype) for k, v in state.items()})
    return model


def init_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights in the flax initialisers' scale: kernels
    normal with std 1/sqrt(fan_in) (lecun), biases 0, norm scales 1, the
    relative attention's ``pos_bias_*`` uniform in +-sqrt(6 / (H + Dh))
    (xavier), the LDE centres ``mu`` standard normal and its ``s`` 1, the
    xi-vector prior and the learnable temperatures 0, the one-class head's
    ``center`` uniform in +-sqrt(0.75) (flax's variance_scaling(0.25,
    "fan_in", "uniform") of a ``[1, D]`` kernel), the margin heads'
    classifier ``weight`` normal with std 0.01 (flax's normal(0.01), JAX
    nn/loss.py:133, 250). The logistic affinity head's ``w`` and ``b``
    keep their constructor's constants."""
    margin_heads = tuple(LOSSES[name] for name in MARGIN_LOSSES)
    classifiers = {id(m.weight) for m in model.modules() if isinstance(m, margin_heads)}
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if id(p) in classifiers:
                p.copy_((torch.randn(p.shape, generator=gen) * 0.01).to(device=p.device, dtype=p.dtype))
            elif leaf in ("weight", "kernel"):
                fan_in = math.prod(p.shape[1:]) if leaf == "weight" else math.prod(p.shape[:-1])
                w = torch.randn(p.shape, generator=gen) * fan_in ** -0.5
                p.copy_(w.to(device=p.device, dtype=p.dtype))
            elif leaf == "bias":
                p.zero_()
            elif leaf in ("scale", "s"):
                p.fill_(1.0)
            elif leaf == "mu":
                p.copy_(torch.randn(p.shape, generator=gen).to(device=p.device, dtype=p.dtype))
            elif leaf in ("prior_mean", "prior_logprec", "t"):
                p.zero_()
            elif leaf == "center":
                limit = math.sqrt(0.75)
                p.copy_(((torch.rand(p.shape, generator=gen) * 2 - 1) * limit).to(device=p.device, dtype=p.dtype))
            elif leaf in ("pos_bias_u", "pos_bias_v"):
                limit = math.sqrt(6.0 / sum(p.shape))
                p.copy_(((torch.rand(p.shape, generator=gen) * 2 - 1) * limit).to(device=p.device, dtype=p.dtype))
    return model


def _check_keys(what: str, got: Mapping[str, torch.Tensor], expected: Mapping[str, torch.Tensor]) -> None:
    missing = sorted(set(expected) - set(got))
    unexpected = sorted(set(got) - set(expected))
    if missing or unexpected:
        raise ValueError(f"{what} do not match the net: missing {missing}, unconsumed {unexpected}")
    for key, value in got.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{what} {key}: shape {tuple(value.shape)} != {tuple(expected[key].shape)}")


def train_state_from_variables(net: nn.Module, tree: Mapping, device: Any = None) -> TrainState:
    """A JAX train state as numpy trees -> the port's ``TrainState`` for ``net``.

    ``tree = {"step", "params", "batch_stats", "opt_state": {"count", and
    moment trees such as "mu", "nu" (adam) or "trace" (sgd momentum)}}``;
    FD's ``opt_state`` is the pair (main, adversary) of such dicts.
    Leaves keep their types; tensors go to ``device`` (the CUDA card unless
    ``device="cpu"``). Raises on a leaf no rule consumes and on a
    parameter, buffer or moment left unset."""
    dev = resolve_device(device)
    extra = set(tree) - {"step", "params", "batch_stats", "opt_state"}
    if extra:
        raise ValueError(f"unexpected train-state entries {sorted(extra)}")
    state = variables_to_state_dict({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    named_params, named_buffers = dict(net.named_parameters()), dict(net.named_buffers())
    params = {k: v for k, v in state.items() if k in named_params}
    stats = {k: v for k, v in state.items() if k not in named_params}
    _check_keys("params", params, named_params)
    _check_keys("batch_stats", stats, named_buffers)
    def optimizer(tree_opt: Mapping) -> dict:
        opt = {"count": torch.as_tensor(np.asarray(tree_opt["count"]), dtype=torch.int32).to(dev)}
        for name, moments in tree_opt.items():
            if name != "count":
                moment = variables_to_state_dict({"params": moments})
                _check_keys(f"optimizer {name}", moment, named_params)
                opt[name] = to_dev(moment)
        return opt

    to_dev = lambda d: {k: v.to(dev) for k, v in d.items()}
    tree_opt = tree["opt_state"]
    return TrainState(
        step=torch.as_tensor(np.asarray(tree["step"]), dtype=torch.int32).to(dev),
        params=to_dev(params), batch_stats=to_dev(stats),
        opt_state=tuple(map(optimizer, tree_opt)) if isinstance(tree_opt, (tuple, list)) else optimizer(tree_opt))


def train_state_to_variables(state: TrainState) -> Dict[str, Any]:
    """The inverse of :func:`train_state_from_variables`: the port's
    ``TrainState`` -> numpy trees in the JAX layout."""
    variables = state_dict_to_variables({**state.params, **state.batch_stats})

    def optimizer(opt: Mapping) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": opt["count"].cpu().numpy()}
        out.update({name: state_dict_to_variables(m)["params"] for name, m in opt.items() if name != "count"})
        return out

    opt_state = state.opt_state
    return {"step": state.step.cpu().numpy(), "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": tuple(map(optimizer, opt_state)) if isinstance(opt_state, tuple) else optimizer(opt_state)}


ecapa_variables_to_state_dict = variables_to_state_dict
ecapa_state_dict_to_variables = state_dict_to_variables
load_ecapa_variables = load_variables
init_ecapa_weights_ = init_weights_
