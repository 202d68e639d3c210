"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU (by
passing ``device="cpu"`` or by handing over CPU tensors). Without a card
and without an explicit request they raise: they never fall back to the
CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
