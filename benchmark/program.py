"""The system under test, built from a configuration's ``port`` entry.

``port.class`` names the backbone (``module:Class``) and ``port.kwargs``
its arguments; ``port.head`` (a loss name and its parameters) wraps it
in the program's ``SpeakerNet`` for training; ``port.flags`` lists the
module attributes (dotted paths) set True after loading, such as the
fused-kernel switches of a served model. The model is built directly on
the device and loaded with the benchmark's seeded tensors by the
program's own parameter names.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch
from torch import nn


def build(cfg: dict, device, weights: Dict[str, torch.Tensor], with_head: bool = False) -> nn.Module:
    port = cfg["port"]
    module, name = port["class"].split(":")
    backbone_cls = getattr(importlib.import_module(module), name)
    with torch.device(device):
        net = backbone_cls(**port["kwargs"], device=device)
        if with_head:
            from asv_subtools_tpu_torch.models.framework import SpeakerNet

            loss_name, loss_params = port["head"]
            net = SpeakerNet(net, loss_name, loss_params, num_targets=cfg["head"]["num_targets"])
    net.load_state_dict(weights)
    for path in port.get("flags", []):
        owner, attr = path.rsplit(".", 1)
        target = net.get_submodule(owner)
        if not hasattr(target, attr):
            raise AttributeError(f"{type(target).__name__} at {owner} has no {attr}")
        setattr(target, attr, True)
    return net


def fbank_options(cfg: dict):
    from asv_subtools_tpu_torch.features.config import FbankOptions, MelOptions

    return FbankOptions(mel_opts=MelOptions(num_bins=cfg["model"]["input_dim"]))
