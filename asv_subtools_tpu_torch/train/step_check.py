"""The nets of the train checks, one SGD step of one on a chosen device
and type, and the distance between two such steps leaf by leaf.

The nets (shared by chip_smoke.py and tests/test_torch_cuda.py): ECAPA-TDNN
(:func:`ecapa_net`), the ResNet x-vector (:func:`resnet_net`), the
Conformer x-vector (:func:`conformer_net`), the TDNN x-vectors
(:func:`xvector_net`: SnowdarXvector 512/512 or FactoredXvector width 1.0,
recipes/configs/{snowdar,factored}_xvector.yaml), the RepVGG x-vector
(:func:`repvgg_net`, recipes/configs/repvgg.yaml), the lawlict ECAPA
(:func:`lawlict_net`, recipes/configs/ecapa_lawlict.yaml) and the
ReConformer (:func:`reconformer_net`, recipes/configs/reconformer.yaml),
each in a
SpeakerNet with a margin head over 5994 classes and seeded random
weights; full width by default, as ``bench.py:58-90`` trains them. The
offline route's nets: :func:`multitask_net` and :func:`fd_net`, whose one
step on features :func:`offline_step` runs (the SAM step too).

``python3 -m asv_subtools_tpu_torch.train.step_check resnet 24`` on a
card splits the f32 step's card-against-CPU gap over seeds between the
front end and the trunk (:func:`f32_gap_split`).
:data:`ROADMAP_ECAPA` is ecapa_roadmap.yaml's backbone (C1024, MQMHA).

The case of the train step's card-against-CPU checks (chip_smoke.py, the
card tests and tools/train_step_conditioning.py): a narrow net of one
family (SpeakerNet(EcapaTdnn(channels=256)) unless told otherwise), B = 8
waves of 2 s, one SGD step of lr 0.1.
The waves are noise under a slow amplitude envelope whose rate differs
from row to row (1.5 to 6 Hz), as syllables modulate speech: stationary
noise gives every row the same pooled statistics after CMVN, and a
train-mode BatchNorm over such a batch divides rounding by a near-zero
spread.

The host's waits on the card in a piece of code (:func:`host_waits`,
used by chip_smoke.py and the card tests) are the warnings that
``torch.cuda.set_sync_debug_mode("warn")`` raises, one a wait.

Leaf distances skip the leaves whose analytic gradient is 0, where both
updates are rounding noise: ``backbone.stats.att2.bias`` (ECAPA's and the
Conformer's attentive pooling: a per-channel constant under a softmax
over time), which :func:`zero_grad_share` reads instead, and any leaf
whose float64 update is noise (:func:`zero_grad_leaves`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..features import FbankOptions, MelOptions, wave_features
from ..models import (ConformerXvector, EcapaLawlict, EcapaTdnn, FactoredXvector, FDXvector, MultiTaskNet,
                      MultiTaskXvector, RepVggXvector, ResNetXvector, SnowdarXvector, SpeakerNet)
from ..weights import init_weights_
from .fd import FDSpeakerNet
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
# a narrow Conformer for the card-against-CPU step: dropout off, since the
# card's generator draws other masks than the CPU's
NARROW_CONFORMER = dict(num_blocks=2, attention_dim=64, attention_heads=2, linear_units=128, dropout_rate=0.0)
NARROW_RESNET = dict(layers=(1, 1, 1, 1), base_planes=8)
# recipes/configs/{snowdar,factored}_xvector.yaml: AM m=0.2
AM = ("margin_softmax", {"method": "am", "m": 0.2})
# recipes/configs/reconformer.yaml's backbone
RECONFORMER = dict(transformer_type="re_conformer", attention_dim=256, attention_heads=4, num_blocks=6,
                   input_layer="re_conv2d", pos_enc_type="rel_pos", embd_dim=256)
NARROW_FTDNN = dict(width=0.125, embd_dim=128)
# recipes/configs/repvgg.yaml: AAM m=0.2 through the sub-centre head's class
REPVGG_AAM = ("margin_softmax_v1", {"method": "aam", "m": 0.2})
NARROW_REPVGG = dict(num_blocks=(1, 1, 1, 1), base_channels=8)
# recipes/configs/ecapa_roadmap.yaml's backbone and head
ROADMAP_ECAPA = dict(pooling="mqmha", pooling_params={"num_q": 2, "num_head": 2})
ROADMAP_HEAD = ("margin_softmax_v1", {"method": "aam", "m": 0.2, "s": 30.0, "sub_k": 2, "adapt_method": "topk",
                                      "topk": 5})
# recipes/configs/ecapa_lawlict.yaml: AM m=0.2 s=30
LAWLICT_AM = ("margin_softmax", {"method": "am", "m": 0.2, "s": 30.0})

# the offline route's nets (recipes/configs/multitask.yaml: the softmax
# head, 128 phones; FD-AL: an AM head and a 9-class softmax auxiliary head;
# SAM on snowdar_xvector.yaml's AM head), narrow for the card-against-CPU step
NARROW_OFFLINE = dict(num_frame_channels=128, embd_dim=128)
PHONES, AUX_CLASSES = 128, 9
FD_CYCLE = dict(cycle=4, adv_steps=2)

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


def ecapa_net(head=SUBCENTER_TOPK, seed: int = 0, channels: int = 256, **backbone: Any) -> SpeakerNet:
    """SpeakerNet(EcapaTdnn(80 bins, channels, embedding 192, MFA 1536,
    ``backbone``)) with ``head`` over 5994 classes and seeded random
    weights, in f32 on the CPU."""
    backbone = EcapaTdnn(80, channels=channels, embd_dim=192, mfa_conv=1536, device="cpu", **backbone)
    return init_weights_(SpeakerNet(backbone, *head, num_targets=NUM_TARGETS), seed)


def resnet_net(head=AAM, seed: int = 0, **backbone: Any) -> SpeakerNet:
    """SpeakerNet(ResNetXvector(80 bins, embedding 512, ``backbone``; base32
    layers 3-4-6-3 by default)) with ``head`` over 5994 classes and seeded
    random weights, in f32 on the CPU: ``bench.py:75-81``."""
    net = SpeakerNet(ResNetXvector(80, device="cpu", **{"embd_dim": 512, **backbone}), *head, num_targets=NUM_TARGETS)
    return init_weights_(net, seed)


def conformer_net(head=AAM, seed: int = 0, **backbone: Any) -> SpeakerNet:
    """SpeakerNet(ConformerXvector(80 bins, ``backbone``; 6L-256D-4H conv2d,
    embedding 256 by default)) with ``head`` over 5994 classes and seeded
    random weights, in f32 on the CPU: ``bench.py:82-90``."""
    kw = {"num_blocks": 6, "attention_dim": 256, "attention_heads": 4, "input_layer": "conv2d", **backbone}
    net = SpeakerNet(ConformerXvector(80, device="cpu", **kw), *head, num_targets=NUM_TARGETS)
    return init_weights_(net, seed)


def xvector_net(family: str = "snowdar", head=AM, seed: int = 0, **backbone: Any) -> SpeakerNet:
    """SpeakerNet(SnowdarXvector(80 bins, 512 channels, embedding 512)) or,
    for ``family="ftdnn"``, SpeakerNet(FactoredXvector(80 bins, width 1.0,
    embedding 512)), with ``backbone`` over those, ``head`` over 5994
    classes and seeded random weights, in f32 on the CPU."""
    if family == "ftdnn":
        model = FactoredXvector(80, device="cpu", **{"width": 1.0, "embd_dim": 512, **backbone})
    else:
        model = SnowdarXvector(80, device="cpu", **{"num_frame_channels": 512, "embd_dim": 512, **backbone})
    return init_weights_(SpeakerNet(model, *head, num_targets=NUM_TARGETS), seed)


def repvgg_net(head=REPVGG_AAM, seed: int = 0, **backbone: Any) -> SpeakerNet:
    """SpeakerNet(RepVggXvector(80 bins, ``backbone``; the reference's
    RepSPK base 32, blocks 2-4-14-1, width (1, 1, 1, 2.5), embedding 256
    by default)) with ``head`` over 5994 classes and seeded random
    weights, in f32 on the CPU."""
    net = SpeakerNet(RepVggXvector(80, device="cpu", **backbone), *head, num_targets=NUM_TARGETS)
    return init_weights_(net, seed)


def lawlict_net(head=LAWLICT_AM, seed: int = 0, **backbone: Any) -> SpeakerNet:
    """SpeakerNet(EcapaLawlict(80 bins, ``backbone``; C512, embedding 192
    by default)) with ``head`` over 5994 classes and seeded random
    weights, in f32 on the CPU."""
    net = SpeakerNet(EcapaLawlict(80, device="cpu", **backbone), *head, num_targets=NUM_TARGETS)
    return init_weights_(net, seed)


def reconformer_net(head=AM, seed: int = 0, **backbone: Any) -> SpeakerNet:
    """SpeakerNet(ConformerXvector(80 bins, reconformer.yaml's
    ``RECONFORMER``, ``backbone`` over it)) with ``head`` (the preset's AM
    m=0.2 by default) over 5994 classes and seeded random weights, in f32
    on the CPU."""
    net = SpeakerNet(ConformerXvector(80, device="cpu", **{**RECONFORMER, **backbone}), *head,
                     num_targets=NUM_TARGETS)
    return init_weights_(net, seed)


def narrow_net(family: str) -> Callable[..., SpeakerNet]:
    """``make_net`` of the card-against-CPU step for ``family`` ("ecapa",
    "resnet", "conformer", "reconformer", "ftdnn" or "repvgg"): the narrow
    net of that family."""
    if family == "ecapa":
        return ecapa_net
    if family == "ftdnn":
        return lambda head=AAM, seed=0: xvector_net("ftdnn", head, seed, **NARROW_FTDNN)
    make, kw = {"resnet": (resnet_net, NARROW_RESNET), "conformer": (conformer_net, NARROW_CONFORMER),
                "reconformer": (reconformer_net, NARROW_CONFORMER), "repvgg": (repvgg_net, NARROW_REPVGG)}[family]
    return lambda head=AAM, seed=0: make(head, seed, **kw)


@dataclasses.dataclass
class StepResult:
    metrics: Dict[str, float]
    updates: Tensors  # new - old params, float64 on the CPU
    batch_stats: Tensors  # the new BN running statistics, float64 on the CPU


def sgd_step(device: Any, dtype: torch.dtype, x: torch.Tensor, y: torch.Tensor, head=SUBCENTER_TOPK,
             seed: int = 0, wave_input: bool = False, make_net: Callable[..., Any] = ecapa_net,
             use_semi_orth: bool = False, **options: Any) -> StepResult:
    """One SGD step (lr 0.1) of ``make_net(head, seed)`` (the narrow ECAPA
    by default) on ``device`` in ``dtype``, on waves (``wave_input``: the
    front end runs in the step, the fbank kernel on a card) or on
    features. The step is step 0: with ``use_semi_orth`` it applies the
    semi-orthogonal update (0 % 4 == 0). ``options`` go to the step's
    TrainStepConfig (``mixup_alpha``, ``remat``)."""
    net = make_net(head, seed).to(torch.float64 if dtype == torch.float64 else torch.float32)
    tx = sgd(0.1)
    state = init_train_state(net, tx, device)
    config = TrainStepConfig(compute_dtype=dtype, wave_input=wave_input, fbank_opts=OPTS, use_semi_orth=use_semi_orth,
                             **options)
    step = make_train_step(net, tx, config=config)
    x = x.to(device) if wave_input else x.to(device, dtype)
    new, m = step(state, {"x": x, "y": y.to(device)}, torch.Generator(device=device).manual_seed(0))
    return StepResult({k: float(v) for k, v in m.items()},
                      {k: (new.params[k] - state.params[k]).double().cpu() for k in state.params},
                      {k: v.double().cpu() for k, v in new.batch_stats.items()})


def zero_grad_leaves(ref: Tensors) -> List[str]:
    """The leaves of the update ``ref`` whose analytic gradient is 0:
    :data:`ZERO_GRAD`, and any leaf whose update is rounding noise, under
    1e-12 of the whole update's norm (read from a float64 update: the
    ResNet's downsample BN shifts whose output reaches train-mode
    BatchNorms only, which take every per-channel constant out)."""
    total = float(torch.sqrt(sum((u ** 2).sum() for u in ref.values())))
    return [k for k, u in ref.items() if k == ZERO_GRAD or float(u.norm()) <= 1e-12 * total]


def worst_leaf(u: Tensors, ref: Tensors) -> Tuple[float, str, float]:
    """(the worst leaf's distance over its norm in ``ref``, that leaf, the
    whole tree's distance over its norm), :func:`zero_grad_leaves` left
    out."""
    skip = set(zero_grad_leaves(ref))
    keys = [k for k in ref if k not in skip]
    errs = {k: float((u[k] - ref[k]).norm() / ref[k].norm()) for k in keys}
    worst = max(errs, key=errs.get)
    whole = float(torch.sqrt(sum(((u[k] - ref[k]) ** 2).sum() for k in keys))
                  / torch.sqrt(sum((ref[k] ** 2).sum() for k in keys)))
    return errs[worst], worst, whole


def worst_stat(u: Tensors, ref: Tensors) -> Tuple[float, str, float]:
    """:func:`worst_leaf` over BatchNorm running statistics, with one
    change: a running mean under 1e-2 of its running std's norm in ``ref``
    is the mean of a map whose mean is 0 by construction (the ResNet's
    stem: a bias-free conv over CMVN'd features), a cancellation whose
    relative error says nothing; its distance is taken over the std's
    norm, the scale at which it enters the normalisation. ECAPA's running
    means all sit above 4e-2 of their std, so its readings are
    :func:`worst_leaf`'s."""
    def scale(k: str) -> float:
        norm = float(ref[k].norm())
        var = ref.get(k[:-len("mean")] + "var") if k.endswith(".mean") else None
        std = float(var.sqrt().norm()) if var is not None else 0.0
        return std if norm < 1e-2 * std else norm

    errs = {k: float((u[k] - ref[k]).norm()) / scale(k) for k in ref}
    worst = max(errs, key=errs.get)
    whole = float(torch.sqrt(sum(((u[k] - ref[k]) ** 2).sum() for k in ref))
                  / torch.sqrt(sum((ref[k] ** 2).sum() for k in ref)))
    return errs[worst], worst, whole


def zero_grad_share(a: Tensors, b: Tensors) -> float:
    """The larger of the two :data:`ZERO_GRAD` updates over the norm of the
    whole update ``b`` (0 for a net without that leaf)."""
    if ZERO_GRAD not in b:
        return 0.0
    total = float(torch.sqrt(sum((u ** 2).sum() for u in b.values())))
    return max(float(a[ZERO_GRAD].norm()), float(b[ZERO_GRAD].norm())) / total


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


SYNC_WARNING = "called a synchronizing CUDA operation"  # what set_sync_debug_mode("warn") raises


def host_waits(fn: Callable[[], Any]) -> Tuple[Any, List[str]]:
    """(fn(), the place, file:line, of each time it waited on the card).

    The mode is set before the recording starts: the first switch in a
    process raises a warning of its own (that the mode is a prototype),
    which is not a wait."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in caught if SYNC_WARNING in str(w.message)]


def multitask_net(seed: int = 0, **backbone: Any) -> MultiTaskNet:
    """MultiTaskNet(MultiTaskXvector(80 bins, ``backbone``; 512/512 by
    default)) with multitask.yaml's softmax head over 5994 classes and 128
    phones, seeded random weights, in f32 on the CPU."""
    model = MultiTaskXvector(80, device="cpu", **{"num_frame_channels": 512, "embd_dim": 512, **backbone})
    return init_weights_(MultiTaskNet(model, NUM_TARGETS, PHONES, "softmax"), seed)


def fd_net(seed: int = 0, **backbone: Any) -> FDSpeakerNet:
    """FDSpeakerNet(FDXvector(80 bins, ``backbone``; 512/512 by default))
    with an AM head over 5994 classes and a softmax auxiliary head over 9,
    seeded random weights, in f32 on the CPU."""
    model = FDXvector(80, device="cpu", **{"num_frame_channels": 512, "embd_dim": 512, **backbone})
    return init_weights_(FDSpeakerNet(model, NUM_TARGETS, AUX_CLASSES, *AM), seed)


def offline_step(kind: str, device: Any, dtype: torch.dtype, feats: torch.Tensor, y: torch.Tensor,
                 seed: int = 0) -> StepResult:
    """One SGD step (lr 0.1) on features [B, T, 80] of the narrow offline-
    route net ``kind`` on ``device`` in ``dtype``: "multitask" (the train
    step on the targets {spk, phone}, seeded phone labels), "fd" (the FD
    step at step index 2 of a cycle of 4 with 2 adversary steps: a main
    step) or "sam" (the SAM step, rho 0.05, of the narrow SnowdarXvector
    with the AM head)."""
    from .fd import make_fd_train_step
    from .sam import make_sam_train_step

    wide = torch.float64 if dtype == torch.float64 else torch.float32
    config = TrainStepConfig(compute_dtype=dtype)
    x = feats.to(device, dtype)
    g = torch.Generator().manual_seed(seed + 1)
    batch = {"x": x, "y": y.to(device)}
    if kind == "multitask":
        net = multitask_net(seed, **NARROW_OFFLINE).to(wide)
        batch["y"] = {"spk": batch["y"], "phone": torch.randint(0, PHONES, x.shape[:2], generator=g).to(device)}
        tx = sgd(0.1)
        state = init_train_state(net, tx, device)
        new, m = make_train_step(net, tx, config=config)(state, batch, torch.Generator(device=device).manual_seed(0))
    elif kind == "fd":
        net = fd_net(seed, **NARROW_OFFLINE).to(wide)
        batch["aux_y"] = torch.randint(0, AUX_CLASSES, y.shape, generator=g).to(device)
        tx = sgd(0.1)
        state = init_train_state(net, tx, device)
        state.opt_state = (state.opt_state, tx.init(state.params))
        new, m = make_fd_train_step(net, tx, tx, config=config, **FD_CYCLE)(state, batch, step_index=2)
    else:
        net = xvector_net("snowdar", AM, seed, **NARROW_OFFLINE).to(wide)
        tx = sgd(0.1)
        state = init_train_state(net, tx, device)
        new, m = make_sam_train_step(net, tx, config=config)(state, batch, torch.Generator(device=device).manual_seed(0))
    return StepResult({k: float(v) for k, v in m.items()},
                      {k: (new.params[k] - state.params[k]).double().cpu() for k in state.params},
                      {k: v.double().cpu() for k, v in new.batch_stats.items()})


def f32_gap_split(family: str, seed: int, card: Any) -> Dict[str, float]:
    """Where an f32 wave-input step of ``narrow_net(family)`` on the card
    parts from the same step on the CPU (the AAM head, waves and weights
    of ``seed``): the relative gaps of grad_norm and loss, card against
    CPU, on waves (each device's front end: the fbank kernel in its f32
    mode on the card, the plain version on the CPU) and on the CPU's
    features (the trunk alone); the front end's largest distance (the
    card's features against the CPU's); and each f32 step's grad_norm
    against the f64 step's on the CPU's features, which says whose f32
    sum moved."""
    make = narrow_net(family)
    wave, y = modulated_waves(8, seed)
    feats = plain_features(wave)
    card_feats = wave_features(wave.to(card), None, OPTS, torch.float32)[0].cpu()
    ref = sgd_step("cpu", torch.float64, feats, y, AAM, seed, make_net=make)
    cd_wave = sgd_step(card, torch.float32, wave, y, AAM, seed, wave_input=True, make_net=make)
    cpu_wave = sgd_step("cpu", torch.float32, wave, y, AAM, seed, wave_input=True, make_net=make)
    cd_feat = sgd_step(card, torch.float32, feats, y, AAM, seed, make_net=make)
    cpu_feat = sgd_step("cpu", torch.float32, feats, y, AAM, seed, make_net=make)
    f64 = ref.metrics["grad_norm"]
    return {"seed": seed,
            "wave_grad_norm": rel(cd_wave.metrics["grad_norm"], cpu_wave.metrics["grad_norm"]),
            "wave_loss": rel(cd_wave.metrics["loss"], cpu_wave.metrics["loss"]),
            "feat_grad_norm": rel(cd_feat.metrics["grad_norm"], cpu_feat.metrics["grad_norm"]),
            "feat_loss": rel(cd_feat.metrics["loss"], cpu_feat.metrics["loss"]),
            "front_end_max_abs": float((card_feats - feats).abs().max()),
            "card_wave_vs_f64": rel(cd_wave.metrics["grad_norm"], f64),
            "cpu_wave_vs_f64": rel(cpu_wave.metrics["grad_norm"], f64),
            "card_feat_vs_f64": rel(cd_feat.metrics["grad_norm"], f64),
            "cpu_feat_vs_f64": rel(cpu_feat.metrics["grad_norm"], f64)}


def main(argv: List[str] = None) -> int:
    """``python3 -m asv_subtools_tpu_torch.train.step_check [FAMILY [SEEDS]]``
    on a machine with a card: :func:`f32_gap_split` for seeds 0 .. SEEDS-1
    (24 by default) of FAMILY (resnet by default), one JSON line a seed,
    then the largest of each reading. TF32 is off."""
    import json
    import sys

    argv = sys.argv[1:] if argv is None else argv
    family = argv[0] if argv else "resnet"
    seeds = int(argv[1]) if len(argv) > 1 else 24
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = [f32_gap_split(family, seed, torch.device("cuda")) for seed in range(seeds)]
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"family": family, "seeds": seeds,
                      **{f"max_{k}": max(r[k] for r in rows) for k in rows[0] if k != "seed"}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
