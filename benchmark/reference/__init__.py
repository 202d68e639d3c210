"""The benchmark's plain reference: float32 PyTorch with TF32 off.

It imports nothing of the program under test and takes nothing the
program made: the benchmark hands it the seeded weights and inputs it
handed the program. One module a model family (``ecapa_tdnn``,
``resnet_xvector``) gives ``param_specs(cfg)``, ``forward(P, feats,
mask, train, q)`` and ``embd_dim(cfg)``; :func:`family` finds it by the
name a configuration gives. ``fbank`` is the front end, ``heads`` the
loss and the optimiser step, ``ops`` the products (and the float8
rounding of the control).
"""

from __future__ import annotations

import contextlib
import importlib
from types import ModuleType
from typing import Dict, Optional, Tuple

import torch

from . import fbank, heads, ops
from .ops import Quant


def family(name: str) -> ModuleType:
    return importlib.import_module(f"{__name__}.{name}")


@contextlib.contextmanager
def full_f32():
    """Products in full float32 on the card: TF32 off, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def embed(fam: ModuleType, P: Dict[str, torch.Tensor], wave: torch.Tensor, valid: Optional[torch.Tensor],
          num_bins: int, q: Quant = None) -> torch.Tensor:
    """Eval-mode embeddings [B, E] of a padded wave batch [B, S] with
    ``valid`` samples a row."""
    with torch.no_grad(), full_f32():
        feats, fmask = fbank.features(wave.float(), valid, num_bins)
        return fam.forward(P, feats, fmask, train=False, q=q)


def train_step(fam: ModuleType, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
               wave: torch.Tensor, targets: torch.Tensor, cfg: dict, state: dict, q: Quant = None,
               batch_stats: Optional[dict] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], dict, torch.Tensor]:
    """One training step of SpeakerNet(backbone, margin head) on whole
    rows of wave [B, S]: features, train-mode forward, the loss, its
    gradients with respect to every parameter, the clip and SGD. ``params`` under
    the program's names (``backbone.*``, ``loss.weight``), ``buffers``
    the BN statistics. -> (new params, clipped gradients, optimiser
    state, loss). ``batch_stats``, a dict, receives each BN's batch mean
    and unbiased variance by its backbone name."""
    num_bins = cfg["model"]["input_dim"]
    with full_f32():
        with torch.no_grad():
            feats, _ = fbank.features(wave.float(), None, num_bins)
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        strip = len("backbone.")
        P = {k[strip:]: v for k, v in {**leaves, **buffers}.items() if k.startswith("backbone.")}
        if batch_stats is not None:
            P[ops.BATCH_STATS] = batch_stats
        emb = fam.forward(P, feats, None, train=True, q=q)
        loss = heads.margin_loss(leaves["loss.weight"], emb, targets, cfg["head"], q)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        with torch.no_grad():
            new, clipped, state = heads.clip_and_sgd({k: params[k] for k in names}, grads, state, cfg["optimizer"],
                                                     cfg["lr_schedule"])
    return new, clipped, state, loss.detach()
