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
  temperatures ``t``, the ReConformer's 0-dim BasicNorm ``eps`` and the
  branch scales ``scale_ff_macaron``, ``scale_mha``, ``scale_conv`` and
  ``scale_ff``, and the Conformer family's leaves that keep their
  layout: the T5 bias ``rel_bias`` ``[32, 1]``, GAU's ``gamma`` and
  ``beta`` ``[2, S]`` (beside GAU's ``uv``), and the attention normalisation's ``att_scale``,
  ``g_sa_omiga``, ``g_sa_bias`` and ``train_len``. The attention's
  kernel-3 ``out`` conv and the conv feed-forwards' ``w1``/``w2`` take
  the 1-D conv rule, ``concat_linear`` the Dense rule. A grouped 1-D
  conv kernel ``[k, in/groups, out]`` and the Conformer's depthwise kernel ``[k, 1, D]`` take the 1-D conv
  rule (``[out, in/groups, k]``); the Dense of a TDNN layer with an
  irregular context (``affine/affine/kernel``, ``[len(ctx) * in, out]``)
  takes the Dense rule; so do the softmax and focal heads'
  ``loss/affine/kernel``. Grouped 2-D kernels ``[kh, kw, in/groups, out]``
  and RepVGG's deployed 5x5 ``reparam`` kernels take the 2-D conv rule.
  A non-affine BatchNorm has no params to map.

The Dense layers of the rest of the TDNN library take the Dense rule:
GruAffine's cell (``cell/{ir,iz,in,hn}`` with a bias, ``cell/{hr,hz}``
without), MultiAffine's ``affine_i``, ChunkSeparationAffine's ``first``
and ``second``; AdaptivePCMN's ``alpha`` and ``beta`` are TDNN convs;
ImportantScale's ``scale`` maps one to one.

A whole train state crosses too (:func:`train_state_from_variables` and
:func:`train_state_to_variables`): the step, the net's params
(``SpeakerNet``, ``MultiTaskNet`` or ``FDSpeakerNet``), the batch_stats
and the optimizer state, whose moment trees (optax's ``mu``, ``nu`` or
``trace``, adamod's ``eta``, lookahead's ``slow``) map by the params'
rules, novograd's one scalar a leaf by its parameter's name; lookahead
holds its base's state under ``inner``; a tuple is optax.chain's (gc's
``({}, base)``) or FD's pair.

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
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .nn.loss import LOSSES, MARGIN_LOSSES
from .train.trainer import TrainState

_SPLIT_CONV = "att1"
_ONE_TO_ONE_PARAMS = ("bias", "scale", "ring_r", "pos_bias_u", "pos_bias_v", "mu", "s", "prior_mean",
                      "prior_logprec", "t", "eps", "scale_ff_macaron", "scale_mha", "scale_conv", "scale_ff",
                      "rel_bias", "att_scale", "g_sa_omiga", "g_sa_bias", "train_len")
# GAU's query/key scale and offset: one to one only in a module with GAU's
# ``uv`` Dense (a BatchNorm's "gamma" or "beta" is no flax leaf)
_GAU_PARAMS = ("gamma", "beta")
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


def _is_gau_param(path: Tuple[str, ...], siblings: Mapping) -> bool:
    return path[-1] in _GAU_PARAMS and len(path) > 1 and "uv" in siblings.get(path[-2], {})


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
        if leaf in _ONE_TO_ONE_PARAMS or _is_loss_param(mods, leaf) or _is_gau_param(path, siblings):
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


def _to_jax(key: str, value: np.ndarray) -> Tuple[str, Tuple[str, ...], np.ndarray]:
    """(collection, path, value in the JAX layout) of one state_dict entry."""
    *mods, leaf = key.split(".")
    if leaf in _STATS:
        return "batch_stats", (*mods, leaf), value
    if leaf in _ONE_TO_ONE_PARAMS + _GAU_PARAMS + ("kernel",) or _is_loss_param(mods, leaf):
        return "params", (*mods, leaf), value
    if leaf == "weight" and value.ndim == 4:
        return "params", (*mods, "kernel"), value.transpose(2, 3, 1, 0)
    if leaf == "weight" and value.ndim == 3:
        return "params", (*mods, "kernel"), value.transpose(2, 1, 0)
    if leaf == "weight" and value.ndim == 2:
        return "params", (*mods, "kernel"), value.T
    raise ValueError(f"no rule maps state_dict key {key} {value.shape}")


def _put(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for m in path[:-1]:
        node = node.setdefault(m, {})
    node[path[-1]] = np.array(value, order="C")


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The inverse: port state_dict -> JAX ``{"params", "batch_stats"}`` tree of numpy arrays."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        collection, path, value = _to_jax(key, tensor.detach().cpu().numpy())
        _put(out[collection], path, value)
    return out


def output_axis(key: str, value: torch.Tensor) -> int:
    """The output axis of a parameter of the port's state_dict: 0 for the
    conv and Dense weights, which the rules transpose from JAX's layout
    (whose output axis is the last), -1 for a leaf that keeps JAX's layout
    (the ``_SplitGlobalConv`` kernel, ``pos_bias_u/v``, the loss heads'
    leaves, ``rel_bias``, GAU's ``gamma`` and ``beta``). Gradient
    centralisation reads it (train/optim.py)."""
    *mods, leaf = key.split(".")
    transposed = leaf == "weight" and value.dim() in (2, 3, 4) and not _is_loss_param(mods, leaf)
    return 0 if transposed else -1


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
    nn/loss.py:133, 250), the T5 bias ``rel_bias`` and GAU's ``gamma``
    normal with std 0.02 and GAU's ``beta`` 0 (JAX attention.py:323,
    363-364). The logistic affinity head's ``w`` and ``b`` and the
    attention normalisation's ``att_scale`` (log(d_k^-0.5)),
    ``g_sa_omiga`` (0.001), ``g_sa_bias`` (-0.001) and ``train_len``
    (log 512) keep their constructor's constants, flax's constant
    initialisers."""
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
            elif leaf in ("prior_mean", "prior_logprec", "t", "beta"):
                p.zero_()
            elif leaf in ("rel_bias", "gamma"):
                p.copy_((torch.randn(p.shape, generator=gen) * 0.02).to(device=p.device, dtype=p.dtype))
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


def _at(tree: Mapping, path: Tuple[str, ...]) -> Tuple[np.ndarray, Mapping]:
    """(the leaf at ``path``, the mapping that holds its module) of a tree."""
    node, parent = tree, {}
    for i, key in enumerate(path):
        if not isinstance(node, Mapping) or key not in node:
            raise ValueError(f"no parameter at {'/'.join(path)}")
        if i == len(path) - 2:
            parent = node
        node = node[key]
    return np.asarray(node), parent


def _is_scalar_moment(moment_dims: Iterable[int], param_dims: Iterable[int]) -> bool:
    """A moment tree of one scalar per leaf (novograd's ``nu``): every leaf
    0-dim while some parameter is not."""
    return all(d == 0 for d in moment_dims) and any(d > 0 for d in param_dims)


def train_state_from_variables(net: nn.Module, tree: Mapping, device: Any = None) -> TrainState:
    """A JAX train state as numpy trees -> the port's ``TrainState`` for ``net``.

    ``tree = {"step", "params", "batch_stats", "opt_state"}``. An optimizer
    state is a dict of ``"count"`` and moment trees (``"mu"``, ``"nu"``,
    adamod's ``"eta"``, sgd's ``"trace"``, lookahead's ``"slow"``), each in
    the params' layout or, for novograd's ``"nu"``, one scalar per leaf;
    lookahead's holds its base's state under ``"inner"``. A tuple is a
    sequence of such states: optax.chain's (gc: ``({}, base)``, gc's state
    empty) or FD's pair (main, adversary). Leaves keep their types;
    tensors go to ``device`` (the CUDA card unless ``device="cpu"``).
    Raises on a leaf no rule consumes and on a parameter, buffer or moment
    left unset."""
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
    to_dev = lambda d: {k: v.to(dev) for k, v in d.items()}

    def moment(name: str, moments: Mapping) -> Dict[str, torch.Tensor]:
        leaves = list(_leaves(moments))
        if not _is_scalar_moment([v.ndim for _, v, _ in leaves], [p.dim() for p in params.values()]):
            out = variables_to_state_dict({"params": moments})
            _check_keys(f"optimizer {name}", out, named_params)
            return out
        out = {}
        for path, value, _ in leaves:
            key, _ = _to_port("params", path, *_at(tree["params"], path))
            if key in out:
                raise ValueError(f"two leaves of optimizer {name} map to {key}")
            out[key] = torch.from_numpy(np.array(value))
        _check_keys(f"optimizer {name}", out, {k: torch.empty(()) for k in named_params})
        return out

    def optimizer(tree_opt: Any) -> Any:
        if isinstance(tree_opt, (tuple, list)):
            return tuple(optimizer(t) for t in tree_opt)
        opt: Dict[str, Any] = {}
        for name, value in tree_opt.items():
            if name == "count":
                opt[name] = torch.as_tensor(np.asarray(value), dtype=torch.int32).to(dev)
            elif name == "inner":
                opt[name] = optimizer(value)
            else:
                opt[name] = to_dev(moment(name, value))
        return opt

    return TrainState(
        step=torch.as_tensor(np.asarray(tree["step"]), dtype=torch.int32).to(dev),
        params=to_dev(params), batch_stats=to_dev(stats), opt_state=optimizer(tree["opt_state"]))


def train_state_to_variables(state: TrainState) -> Dict[str, Any]:
    """The inverse of :func:`train_state_from_variables`: the port's
    ``TrainState`` -> numpy trees in the JAX layout."""
    variables = state_dict_to_variables({**state.params, **state.batch_stats})

    def moment(m: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        if not _is_scalar_moment([v.dim() for v in m.values()], [p.dim() for p in state.params.values()]):
            return state_dict_to_variables(m)["params"]
        out: Dict[str, Any] = {}
        for key, value in m.items():
            _, path, _ = _to_jax(key, state.params[key].detach().cpu().numpy())
            _put(out, path, value.cpu().numpy())
        return out

    def optimizer(opt: Any) -> Any:
        if isinstance(opt, tuple):
            return tuple(optimizer(o) for o in opt)
        return {name: opt[name].cpu().numpy() if name == "count" else optimizer(v) if name == "inner" else moment(v)
                for name, v in opt.items()}

    return {"step": state.step.cpu().numpy(), "params": variables["params"],
            "batch_stats": variables["batch_stats"], "opt_state": optimizer(state.opt_state)}


ecapa_variables_to_state_dict = variables_to_state_dict
ecapa_state_dict_to_variables = state_dict_to_variables
load_ecapa_variables = load_variables
init_ecapa_weights_ = init_weights_
