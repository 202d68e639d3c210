"""The trainable unit and embedding helpers (counterpart: asv_subtools_tpu/models/framework.py)."""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn.loss import LOSSES, MARGIN_LOSSES, Scalar


class SpeakerNet(nn.Module):
    """Backbone + loss head, the trainable unit (JAX framework.py:31-80).

    The backbone maps ``[B, T, D]`` (and a ``[B, T]`` mask) to ``[B, E]``
    and names its embedding width ``embd_dim``; ``loss_name`` and
    ``loss_params`` pick the head from :data:`~asv_subtools_tpu_torch.nn.loss.LOSSES`,
    which owns the classifier weight (``loss.weight``, ``[C * sub_k, E]``
    for the margin losses; ``loss.affine`` for softmax and focal). The
    head is built on the backbone's device; only the margin heads get
    ``lambda_m`` and ``margin_offset``.
    The backbone gets ``generator`` (dropout draws) and ``warmup`` (the
    Conformer's layer blend) only where its ``forward`` declares them, as
    the JAX SpeakerNet hands a backbone only what its signature takes.
    """

    def __init__(self, backbone: nn.Module, loss_name: str = "margin_softmax",
                 loss_params: Optional[dict] = None, num_targets: int = 0):
        super().__init__()
        self.backbone = backbone
        self._margin = loss_name in MARGIN_LOSSES
        self.loss = LOSSES[loss_name](backbone.embd_dim, num_targets, **(loss_params or {}))
        self.loss.to(next(backbone.parameters()).device)
        self._backbone_takes = set(inspect.signature(type(backbone).forward).parameters) & {"generator", "warmup"}
        self.train(backbone.training)

    def forward(self, x: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
                lambda_m: Scalar = 1.0, margin_offset: Scalar = 0.0,
                generator: Optional[torch.Generator] = None,
                warmup: Scalar = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (loss, logits, embeddings); the margin applies in train mode."""
        given = {"generator": generator, "warmup": warmup}
        emb = self.backbone(x, mask, **{k: given[k] for k in self._backbone_takes})
        margin = {"lambda_m": lambda_m, "margin_offset": margin_offset} if self._margin else {}
        loss, logits = self.loss(emb, targets, **margin)
        return loss, logits, emb

    def embed(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, position: str = "near") -> torch.Tensor:
        return self.backbone(x, mask, position=position)


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


def extract_embedding_chunked(embed_fn: Callable, feats: Any, max_chunk: int = 10000,
                              device: Any = None) -> torch.Tensor:
    """Whole-utterance embedding of feats [T, D]: :func:`chunk_utterance`'s
    chunks embedded in one batched call ``embed_fn(chunks [n, L, D],
    None) -> [n, E]`` on ``device`` (the CUDA card unless ``device="cpu"``;
    raises without a card), then averaged with the chunks' frame weights
    (JAX framework.py:107)."""
    dev = resolve_device(device)
    feats = feats.detach().cpu().numpy() if isinstance(feats, torch.Tensor) else np.asarray(feats)
    chunks, weights = chunk_utterance(feats, max_chunk)
    embs = embed_fn(torch.from_numpy(chunks).to(dev), None)
    return (embs * torch.from_numpy(weights).to(dev)[:, None]).sum(0)


def l2_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), eps)


def count_params(params: Any) -> int:
    """The number of parameters of a module, or of a {name: tensor} dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(p.numel() for p in tensors)
