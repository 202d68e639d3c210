"""Operations and bytes of the Conformer's relative-position attention, a
layer at a batch's shapes, for ``conformer.attention_roofline``.

The work of one layer over bf16 x [B, T', D] with H heads of Dh = D / H:
the fused q, k, v product, the position product over the [T', D] table,
the output product, and the three [T', T'] products a head (``(q + u)
k^T``, ``(q + v) p^T`` and the weights times v). The bytes are x read
once, the layer's bf16 weights and biases, and the output written once:
the [T', T'] scores are the program's choice of how to compute the
layer, not its need. T' comes from the frames by the ``conv2d2``
subsampling's length formula.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from ..reference import fbank
from ..reference.conformer import subsampled_frames


def attention_layer(batch: int, t: int, dim: int, heads: int) -> Tuple[float, float]:
    """One relative-position attention layer over x [batch, t, dim]."""
    projections = 2.0 * batch * t * dim * (3 * dim + dim) + 2.0 * t * dim * dim  # qkv and out; pos
    scores = 3 * 2.0 * batch * t * t * dim  # ac, bd and the product with v, over all heads
    weights = 3 * dim * dim + 3 * dim + dim * dim + dim + dim * dim + 2 * dim  # qkv, out, pos, u and v
    nbytes = 2.0 * (2 * batch * t * dim + weights)
    return projections + scores, nbytes


def attention_work(cfg: dict, work: Iterable[Tuple[int, int]]) -> Iterable[Tuple[float, float]]:
    """(operations, bytes) of every attention layer of every batch in
    ``work``, (rows, padded samples) a batch."""
    m = cfg["model"]
    for b, s in work:
        t = subsampled_frames(fbank.num_frames(s))
        for _ in range(m["num_blocks"]):
            yield attention_layer(b, t, m["attention_dim"], m["attention_heads"])
