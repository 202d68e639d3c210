"""Attention masks (counterpart: asv_subtools_tpu/nn/conformer/mask.py:15-103).

Boolean masks, True = attend: the padding mask, the chunk mask of
streaming training (:func:`chunk_mask`) and wenet's dynamic chunk
policy, split into a draw (:func:`dynamic_chunk_draw`, on the
generator's device, no host read) and an apply (:func:`chunk_mask`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True for valid positions (the inverse of wenet's pad mask)."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def chunk_mask(size: int, chunk_size: Union[int, torch.Tensor], num_left_chunks: Union[int, torch.Tensor],
               device: Optional[torch.device] = None) -> torch.Tensor:
    """[T, T] chunk-causal mask: position i attends within its chunk and
    up to ``num_left_chunks`` earlier chunks (all of them when < 0): JAX's
    ``subsequent_chunk_mask`` (mask.py:21-33) for Python numbers, its
    ``_traced_chunk_mask`` (:36-44) for 0-dim tensors (the dynamic draw's)."""
    if isinstance(chunk_size, torch.Tensor):
        device = chunk_size.device
    co = torch.arange(size, device=device) // (torch.clamp_min(chunk_size, 1)
                                               if isinstance(chunk_size, torch.Tensor) else max(chunk_size, 1))
    q, k = co[:, None], co[None, :]
    ok = k <= q
    if isinstance(num_left_chunks, torch.Tensor):
        return torch.where(num_left_chunks >= 0, ok & (k >= q - num_left_chunks), ok)
    return ok & (k >= q - num_left_chunks) if num_left_chunks >= 0 else ok


def dynamic_chunk_draw(generator: Optional[torch.Generator], size: int, use_dynamic_left_chunk: bool = False,
                       device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """wenet's dynamic chunk policy (JAX mask.py:47-66): c ~ U[1, max(T, 2));
    above T // 2 the batch trains with full context (chunk T, left -1),
    else chunk = c % 25 + 1 and, under ``use_dynamic_left_chunk``, a left
    count ~ U[0, max((T - 1) // chunk, 1)). -> (chunk, left) int64 0-dim
    tensors on ``device``, drawn from ``generator``."""
    c = torch.randint(1, max(size, 2), (), generator=generator, device=device)
    u = torch.rand((), generator=generator, device=device)
    full = c > size // 2
    chunk = torch.where(full, size, c % 25 + 1)
    left = torch.full((), -1, dtype=torch.int64, device=device)
    if use_dynamic_left_chunk:
        max_left = torch.clamp_min((size - 1) // chunk, 1)
        draw = torch.minimum((u * max_left).to(torch.int64), max_left - 1)
        left = torch.where(full, left, draw)
    return chunk, left


def dynamic_chunk_mask(generator: Optional[torch.Generator], size: int, use_dynamic_left_chunk: bool = False,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """The draw and its [T, T] mask."""
    return chunk_mask(size, *dynamic_chunk_draw(generator, size, use_dynamic_left_chunk, device))


def chunk_mask_applies(static_chunk_size: int = 0, use_dynamic_chunk: bool = False, draw: bool = False,
                       decoding_chunk_size: int = 0) -> bool:
    """Whether :func:`add_optional_chunk_mask` adds a chunk mask to the
    padding mask under these options (else the attention mask is the
    padding mask's alone)."""
    if use_dynamic_chunk:
        return decoding_chunk_size > 0 or (decoding_chunk_size == 0 and draw)
    return static_chunk_size > 0


def add_optional_chunk_mask(pad_mask: Optional[torch.Tensor], size: int, static_chunk_size: int = 0,
                            num_left_chunks: int = -1, use_dynamic_chunk: bool = False,
                            use_dynamic_left_chunk: bool = False, draw: bool = False,
                            generator: Optional[torch.Generator] = None, decoding_chunk_size: int = 0,
                            device: Optional[torch.device] = None) -> Optional[torch.Tensor]:
    """Padding mask [B, T] (+ a chunk mask) -> attention mask [B, 1, T, T]
    (or [1, 1, T, T] without padding; None when neither applies), JAX
    mask.py:69-103. Under ``use_dynamic_chunk``: a fixed decoding chunk
    when ``decoding_chunk_size`` > 0, the dynamic draw from ``generator``
    when ``draw`` (training) and ``decoding_chunk_size`` == 0, else full
    context (evaluation). Otherwise ``static_chunk_size`` > 0 applies the
    static chunk mask."""
    if pad_mask is not None:
        device = pad_mask.device
    att = None if pad_mask is None else pad_mask[:, None, None, :] & pad_mask[:, None, :, None]
    if not chunk_mask_applies(static_chunk_size, use_dynamic_chunk, draw, decoding_chunk_size):
        return att
    if not use_dynamic_chunk:
        cm = chunk_mask(size, static_chunk_size, num_left_chunks, device)
    elif decoding_chunk_size > 0:
        cm = chunk_mask(size, decoding_chunk_size, num_left_chunks, device)
    else:
        cm = dynamic_chunk_mask(generator, size, use_dynamic_left_chunk, device)
    cm = cm[None, None]
    return cm if att is None else att & cm
