"""Seeded weights for both sides, made on the device in one draw.

Every tensor of a configuration (parameters and BatchNorm statistics,
under the program's state_dict names, as the reference family's
``param_specs`` lists them) is cut from one ``torch.randn`` of a
``torch.Generator`` on the device, then scaled by its kind: weights by
``fan_in ** -0.5``, biases by 0.05, BN scales 1 + 0.1 n, BN shifts and
running means 0.1 n, running variances exp(0.2 n). Running statistics
are thus never the identity. The tensors come in the type they are
served or trained in; the reference takes them as float32.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, int]


def seeded_tensors(specs: Iterable[Spec], seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    specs = list(specs)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, start = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        x = flat[start:start + n].view(shape)
        start += n
        if kind == "weight":
            x = x * fan_in ** -0.5
        elif kind == "bias":
            x = x * 0.05
        elif kind == "bn_scale":
            x = 1.0 + 0.1 * x
        elif kind in ("bn_bias", "bn_mean"):
            x = 0.1 * x
        elif kind == "bn_var":
            x = torch.exp(0.2 * x)
        elif kind != "class_weight":
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = x.to(dtype).contiguous()
    return out
