"""Activation functions by name (counterpart: asv_subtools_tpu/nn/activations.py).

Plain functions on tensors; :func:`get_activation` is the factory the
TDNN layers use. ``None``, ``""`` and ``"none"`` name no activation.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x - 1), the k2/icefall variant."""
    return x * torch.sigmoid(x - 1.0)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "gelu": _gelu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "selu": F.selu,
    "mish": mish,
    "swish": swish,
    "double_swish": double_swish,
    "elu": F.elu,
    "softplus": F.softplus,
    "": None,
    "none": None,
    None: None,
}


def get_activation(name: Union[str, Callable, None]) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    if callable(name):
        return name
    key = name.lower() if isinstance(name, str) else name
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation {name!r}")
    return _ACTIVATIONS[key]
