"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU (by
passing ``device="cpu"`` or by handing over CPU tensors). Without a card
and without an explicit request they raise: they never fall back to the
CPU on their own. Under an initialised process group (one process a
card, parallel/mesh.py) the card is ``cuda:local_index()``, the one
``initialize_multihost`` makes the process's current device.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def local_index() -> int:
    """This process's card under a process group: LOCAL_RANK (torchrun),
    else the global rank (one host, one process a card, as JAX-style
    ``initialize_multihost`` arguments start it)."""
    return int(os.environ.get("LOCAL_RANK", torch.distributed.get_rank()))


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.device("cuda", local_index())
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
