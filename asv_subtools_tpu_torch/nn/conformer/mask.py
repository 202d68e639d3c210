"""Attention masks (counterpart: asv_subtools_tpu/nn/conformer/mask.py).

Boolean masks, True = attend. Only the padding part is ported: the static
and dynamic chunk masks of streaming training raise.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True for valid positions (the inverse of wenet's pad mask)."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def add_optional_chunk_mask(pad_mask: Optional[torch.Tensor], size: int, static_chunk_size: int = 0,
                            num_left_chunks: int = -1, use_dynamic_chunk: bool = False,
                            use_dynamic_left_chunk: bool = False,
                            decoding_chunk_size: int = 0) -> Optional[torch.Tensor]:
    """Padding mask [B, T] -> attention mask [B, 1, T, T]: a query and a key
    attend each other when both are valid. None stays None."""
    if use_dynamic_chunk or static_chunk_size > 0:
        raise NotImplementedError("chunk masks (static_chunk_size, use_dynamic_chunk) are not ported yet "
                                  "(ROADMAP Queue 1 item 3)")
    if pad_mask is None:
        return None
    return pad_mask[:, None, None, :] & pad_mask[:, None, :, None]
