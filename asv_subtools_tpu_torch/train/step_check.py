"""One SGD step of a small ECAPA-TDNN on a chosen device and type, and the
distance between two such steps leaf by leaf.

The case of the train step's card-against-CPU checks (chip_smoke.py, the
card tests and tools/train_step_conditioning.py):
SpeakerNet(EcapaTdnn(channels=256)) with seeded random weights and a
margin head over 5994 classes, B = 8 waves of 2 s, one SGD step of lr 0.1.
The waves are noise under a slow amplitude envelope whose rate differs
from row to row (1.5 to 6 Hz), as syllables modulate speech: stationary
noise gives every row the same pooled statistics after CMVN, and a
train-mode BatchNorm over such a batch divides rounding by a near-zero
spread.

Leaf distances skip ``backbone.stats.att2.bias``: it adds a per-channel
constant under a softmax over time, so its analytic gradient is 0 and
both updates are rounding noise; :func:`zero_grad_share` reads it instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..features import FbankOptions, MelOptions, wave_features
from ..models import EcapaTdnn, SpeakerNet
from ..weights import init_weights_
from .trainer import TrainStepConfig, init_train_state, make_train_step
from .optim import sgd

SAMPLES = 32000  # 2 s at 16 kHz
NUM_TARGETS = 5994  # voxceleb2 dev speakers
OPTS = FbankOptions(mel_opts=MelOptions(num_bins=80))
SUBCENTER_TOPK = ("margin_softmax_v1", {"method": "aam", "m": 0.2, "s": 30, "sub_k": 2, "adapt_method": "topk",
                                        "topk": 5})
# the AAM margin softmax computes in float64 when its input is float64;
# the sub-centre head computes in float32 whatever its input (as in JAX)
AAM = ("margin_softmax", {"method": "aam", "m": 0.2})
ZERO_GRAD = "backbone.stats.att2.bias"

Tensors = Dict[str, torch.Tensor]


def modulated_waves(b: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(waves [b, 32000] f32, labels [b] over 5994 classes) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(SAMPLES) / 16000.0
    rate = torch.linspace(1.5, 6.0, b)[:, None]
    env = 1.0 + 0.9 * torch.sin(2 * np.pi * rate * t + torch.rand(b, 1, generator=g) * 6.0)
    x = torch.randn(b, SAMPLES, generator=g) * 1000.0 * env
    return x, torch.randint(0, NUM_TARGETS, (b,), generator=g)


def plain_features(waves: torch.Tensor) -> torch.Tensor:
    """The CMVN'd f32 log-mel of the plain front end, made on the CPU."""
    return wave_features(waves.cpu(), None, OPTS, torch.float32)[0]


def ecapa_net(head=SUBCENTER_TOPK, seed: int = 0, channels: int = 256) -> SpeakerNet:
    """SpeakerNet(EcapaTdnn(80 bins, channels, embedding 192, MFA 1536)) with
    ``head`` over 5994 classes and seeded random weights, in f32 on the CPU."""
    backbone = EcapaTdnn(80, channels=channels, embd_dim=192, mfa_conv=1536, device="cpu")
    return init_weights_(SpeakerNet(backbone, *head, num_targets=NUM_TARGETS), seed)


@dataclasses.dataclass
class StepResult:
    metrics: Dict[str, float]
    updates: Tensors  # new - old params, float64 on the CPU
    batch_stats: Tensors  # the new BN running statistics, float64 on the CPU


def sgd_step(device: Any, dtype: torch.dtype, x: torch.Tensor, y: torch.Tensor, head=SUBCENTER_TOPK,
             seed: int = 0, wave_input: bool = False) -> StepResult:
    """One SGD step (lr 0.1) of :func:`ecapa_net` on ``device`` in
    ``dtype``, on waves (``wave_input``: the front end runs in the step,
    the fbank kernel on a card) or on features."""
    net = ecapa_net(head, seed).to(torch.float64 if dtype == torch.float64 else torch.float32)
    tx = sgd(0.1)
    state = init_train_state(net, tx, device)
    config = TrainStepConfig(compute_dtype=dtype, wave_input=wave_input, fbank_opts=OPTS)
    step = make_train_step(net, tx, config=config)
    x = x.to(device) if wave_input else x.to(device, dtype)
    new, m = step(state, {"x": x, "y": y.to(device)}, torch.Generator(device=device).manual_seed(0))
    return StepResult({k: float(v) for k, v in m.items()},
                      {k: (new.params[k] - state.params[k]).double().cpu() for k in state.params},
                      {k: v.double().cpu() for k, v in new.batch_stats.items()})


def worst_leaf(u: Tensors, ref: Tensors) -> Tuple[float, str, float]:
    """(the worst leaf's distance over its norm in ``ref``, that leaf, the
    whole tree's distance over its norm), :data:`ZERO_GRAD` left out."""
    errs = {k: float((u[k] - ref[k]).norm() / ref[k].norm()) for k in ref if k != ZERO_GRAD}
    worst = max(errs, key=errs.get)
    keys = [k for k in ref if k != ZERO_GRAD]
    whole = float(torch.sqrt(sum(((u[k] - ref[k]) ** 2).sum() for k in keys))
                  / torch.sqrt(sum((ref[k] ** 2).sum() for k in keys)))
    return errs[worst], worst, whole


def zero_grad_share(a: Tensors, b: Tensors) -> float:
    """The larger of the two :data:`ZERO_GRAD` updates over the norm of the
    whole update ``b``."""
    total = float(torch.sqrt(sum((u ** 2).sum() for u in b.values())))
    return max(float(a[ZERO_GRAD].norm()), float(b[ZERO_GRAD].norm())) / total


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
