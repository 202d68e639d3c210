"""Operations of a configuration's network, counted once on the plain
reference with ``torch.utils.flop_counter.FlopCounterMode`` on the meta
device: products and convolutions, forward only for extraction, forward
and backward (the margin head included) for training, nothing recomputed.

Both families' counts are affine in the number of frames (every
frame-level layer is linear in T; the pooled layers are not), so
:func:`per_utterance` counts at two lengths and gives a function of T.
Counting on the reference means the count is of the work the
configuration needs, whatever kernels a version of the program runs.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import reference
from ..reference import heads


def _meta_params(fam, cfg: dict, grad: bool):
    return {name: torch.empty(shape, device="meta", requires_grad=grad and not name.endswith((".mean", ".var")))
            for name, shape, _, _ in fam.param_specs(cfg)}


def network_flops(cfg: dict, frames: int, batch: int = 1, train: bool = False) -> float:
    """Operations of one call at [batch, frames, bins]; with ``train`` the
    forward, the margin head and the backward to every parameter."""
    fam = reference.family(cfg["reference"])
    P = _meta_params(fam, cfg, train)
    feats = torch.empty(batch, frames, cfg["model"]["input_dim"], device="meta")
    with FlopCounterMode(display=False) as counter:
        if not train:
            with torch.no_grad():
                fam.forward(P, feats, None, train=False)
        else:
            w = torch.empty(cfg["head"]["num_targets"], fam.embd_dim(cfg), device="meta", requires_grad=True)
            targets = torch.zeros(batch, dtype=torch.long, device="meta")
            loss = heads.margin_loss(w, fam.forward(P, feats, None, train=True), targets, cfg["head"])
            leaves = [p for p in P.values() if p.requires_grad] + [w]
            torch.autograd.grad(loss, leaves)
    return float(counter.get_total_flops())


def per_utterance(cfg: dict, t1: int = 200, t2: int = 400) -> Callable[[int], float]:
    """f(T): the forward's operations for one utterance of T frames,
    interpolated from the counts at ``t1`` and ``t2``."""
    f1, f2 = network_flops(cfg, t1), network_flops(cfg, t2)
    slope = (f2 - f1) / (t2 - t1)
    return lambda t: f1 + slope * (t - t1)
