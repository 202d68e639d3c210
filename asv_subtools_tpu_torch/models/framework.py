"""Embedding helpers (counterpart: asv_subtools_tpu/models/framework.py:81-124)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def chunk_utterance(feats: np.ndarray, max_chunk: int = 10000) -> Tuple[np.ndarray, np.ndarray]:
    """Split [T, D] into [n, chunk, D] equal chunks + per-chunk frame weights.

    Mirrors the reference's for_extract_embedding (framework.py:27-52):
    ceil(T / max_chunk) chunks of floor(T / split) frames; the remainder is
    covered by one more chunk that overlaps back, weighted by its novel
    frames only. The weights sum to 1.
    """
    t = feats.shape[0]
    if t <= max_chunk:
        return feats[None], np.ones(1, np.float32)
    num_split = -(-t // max_chunk)
    length = t // num_split
    chunks = [feats[i * length : (i + 1) * length] for i in range(num_split)]
    remainder = t - num_split * length
    weights = np.full(num_split, length, np.float32)
    if remainder > 0:
        chunks.append(feats[t - length :])
        weights = np.concatenate([weights, np.asarray([remainder], np.float32)])
    return np.stack(chunks), weights / weights.sum()


def l2_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), eps)
