"""Cosine scoring on the device (counterpart: asv_subtools_tpu/backend/score_norm.py:169-182)."""

from __future__ import annotations

import torch


def cosine_score_matrix(enroll: torch.Tensor, test: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """[E, D] x [T, D] -> cosine scores [E, T] in f32, as one matrix
    product on the tensors' device."""
    e = torch.as_tensor(enroll).to(torch.float32)
    t = torch.as_tensor(test).to(device=e.device, dtype=torch.float32)
    if normalize:
        e = e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True), 1e-12)
        t = t / torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True), 1e-12)
    return e @ t.T
