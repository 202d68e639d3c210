"""The benchmark's plain reference against the program, on the CPU at
small widths and short waves, and the frozen counts.

    python -m pytest benchmark/ -q
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.counts import kernels, model_flops
from benchmark.reference import fbank
from benchmark.reference.ops import fp8_round
from benchmark.weights import seeded_tensors

REPO = Path(__file__).resolve().parent.parent
NARROW_ECAPA = {"reference": "ecapa_tdnn", "model": {"input_dim": 80, "channels": 64, "mfa_conv": 96, "embd_dim": 16}}
NARROW_RESNET = {"reference": "resnet_xvector",
                 "model": {"input_dim": 80, "layers": [1, 1, 1, 1], "base_planes": 8, "embd_dim": 16},
                 "head": {"name": "am", "m": 0.2, "s": 30.0, "num_targets": 10},
                 "optimizer": {"name": "sgd", "momentum": 0.9, "weight_decay": 1e-4, "max_change": 10.0},
                 "lr_schedule": {"name": "warmR", "base_lr": 0.01, "t_0": 5, "eta_min": 1e-6}}


def _padded_waves(rows, samples, valid, seed=1):
    g = torch.Generator().manual_seed(seed)
    wave = torch.round(torch.randn(rows, samples, generator=g) * 3000)
    valid = torch.as_tensor(valid)
    return wave * (torch.arange(samples)[None] < valid[:, None]), valid


def _opts():
    from asv_subtools_tpu_torch.features.config import FbankOptions, MelOptions

    return FbankOptions(mel_opts=MelOptions(num_bins=80))


def test_fbank_and_cmvn_match_the_program():
    from asv_subtools_tpu_torch.features.fused_fbank import wave_features

    wave, valid = _padded_waves(3, 16000, [16000, 9000, 5000])
    mask = torch.arange(16000)[None] < valid[:, None]
    got, gmask = wave_features(wave, mask, _opts(), torch.float32)
    ref, rmask = fbank.features(wave, valid, 80)
    assert torch.equal(gmask, rmask)
    # f32 sums of a 400-tap product against an FFT, on log-mel values of ~20
    assert float((got - ref).abs().max()) < 1e-3


@pytest.mark.parametrize("train", [False, True])
def test_ecapa_matches_the_program(train):
    from asv_subtools_tpu_torch.models.ecapa import EcapaTdnn

    fam = reference.family("ecapa_tdnn")
    p = seeded_tensors(fam.param_specs(NARROW_ECAPA), 5, "cpu", torch.float32)
    model = EcapaTdnn(80, channels=64, embd_dim=16, mfa_conv=96, device="cpu")
    model.load_state_dict(p)
    model.train(train)
    wave, valid = _padded_waves(4, 16000, [16000, 9000, 5000, 12000])
    feats, fmask = fbank.features(wave, valid, 80)
    with torch.no_grad():
        got = model(feats, fmask)
        want = fam.forward(p, feats, fmask, train=train)
    gap = torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)
    assert float(gap.max()) < 1e-4


def test_resnet_eval_matches_the_program():
    from asv_subtools_tpu_torch.models.resnet_xvector import ResNetXvector

    fam = reference.family("resnet_xvector")
    p = seeded_tensors(fam.param_specs(NARROW_RESNET), 6, "cpu", torch.float32)
    model = ResNetXvector(80, layers=(1, 1, 1, 1), base_planes=8, embd_dim=16, device="cpu")
    model.load_state_dict(p)
    wave, valid = _padded_waves(3, 16000, [16000, 9000, 7000])
    feats, fmask = fbank.features(wave, valid, 80)
    with torch.no_grad():
        got, want = model(feats, fmask), fam.forward(p, feats, fmask)
    assert float((torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)).max()) < 1e-4


@pytest.mark.parametrize("method", ["am", "aam"])
def test_resnet_train_steps_match_the_program(method):
    from asv_subtools_tpu_torch.models.framework import SpeakerNet
    from asv_subtools_tpu_torch.models.resnet_xvector import ResNetXvector
    from asv_subtools_tpu_torch.train import (TrainStepConfig, get_lr_schedule, get_optimizer, init_train_state,
                                              make_train_step)

    cfg = dict(NARROW_RESNET, head=dict(NARROW_RESNET["head"], name=method))
    fam = reference.family("resnet_xvector")
    specs = [("backbone." + n, s, k, f) for n, s, k, f in fam.param_specs(cfg)]
    p = seeded_tensors(specs + [("loss.weight", (10, 16), "class_weight", 0)], 5, "cpu", torch.float32)
    net = SpeakerNet(ResNetXvector(80, layers=(1, 1, 1, 1), base_planes=8, embd_dim=16, device="cpu"),
                     "margin_softmax", {"method": method, "m": 0.2, "s": 30.0}, num_targets=10)
    net.load_state_dict(p)
    tx = get_optimizer("sgd", learning_rate=get_lr_schedule(**cfg["lr_schedule"]), momentum=0.9, weight_decay=1e-4)
    state = init_train_state(net, tx, "cpu")
    step = make_train_step(net, tx, config=TrainStepConfig(compute_dtype=torch.float32, wave_input=True,
                                                           fbank_opts=_opts()))
    g = torch.Generator().manual_seed(1)
    buffers = {k: v for k, v in p.items() if k not in state.params}
    params, opt_state = {k: v.contiguous() for k, v in p.items() if k not in buffers}, {}
    for i in range(3):  # three steps: the momentum and the schedule's steps in the change
        wave, y = torch.round(torch.randn(4, 8000, generator=g) * 3000), torch.randint(0, 10, (4,), generator=g)
        state, metrics = step(state, {"x": wave, "y": y}, torch.Generator())
        params, clipped, opt_state, loss = reference.train_step(fam, params, buffers, wave, y, cfg, opt_state)
        assert abs(float(metrics["loss"]) - float(loss)) < 1e-4 * float(loss), i
        if i == 0:
            norms = {k: float(clipped[k].norm()) for k in clipped}
            median = float(np.median(list(norms.values())))
            for k in clipped:
                g_prog = state.opt_state["trace"][k] - 1e-4 * p[k]
                # the others are nought to rounding (a bias ahead of a train-mode BN)
                if norms[k] >= 1e-3 * median:
                    assert float((g_prog - clipped[k]).norm()) < 1e-3 * norms[k], k
    for k in params:
        d_prog, d_ref = state.params[k] - p[k], params[k] - p[k]
        if norms[k] >= 1e-3 * median:
            assert float((d_prog - d_ref).norm()) < 1e-3 * float(d_ref.norm()), k


def test_interpolated_flops_match_a_direct_count():
    for cfg in (NARROW_ECAPA, {"reference": "ecapa_tdnn",
                               "model": {"input_dim": 80, "channels": 1024, "mfa_conv": 1536, "embd_dim": 192}}):
        f = model_flops.per_utterance(cfg)
        assert f(777) == pytest.approx(model_flops.network_flops(cfg, 777), rel=1e-9)
    # ECAPA C1024: about 25.7 MFLOP a frame
    assert 25e6 < (f(1000) - f(0)) / 1000 < 26.5e6


def test_train_flops_count_forward_and_backward():
    fwd = model_flops.network_flops(NARROW_RESNET, 200, 4)
    both = model_flops.network_flops(NARROW_RESNET, 200, 4, train=True)
    assert 2.5 * fwd < both < 3.2 * fwd


def test_kernel_counts_are_chip_smokes():
    # chip_smoke's K1 at B=128 x 10 s: 52.5 GFLOP, 123.2 MB; 501 mel weights
    flops, nbytes = kernels.k1(128, 160000)
    assert kernels.mel_nonzeros(80) == 501
    assert flops == pytest.approx(52.45e9, rel=1e-3) and nbytes == pytest.approx(123.2e6, rel=1e-3)
    assert kernels.k2(128, 998, 1536)[0] == pytest.approx(100.5e9, rel=1e-3)
    assert kernels.k3(128, 998, 1024)[0] == pytest.approx(87.9e9, rel=1e-3)


def test_fp8_control_rounds_operands_and_gradients():
    x = torch.randn(64, 64, requires_grad=True)
    w = torch.randn(64, 64, requires_grad=True)
    y = reference.ops.matmul(x, w, fp8_round)
    rel = float((y - x @ w).detach().norm() / (x @ w).detach().norm())
    assert 5e-3 < rel < 0.1  # e4m3 keeps three mantissa bits
    y.sum().backward()
    exact = torch.ones(64, 64) @ w.detach().t()
    assert float((x.grad - exact).norm() / exact.norm()) > 1e-3


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import benchmark.reference, benchmark.reference.ecapa_tdnn, "
                            "benchmark.reference.resnet_xvector, benchmark.counts.model_flops, "
                            "benchmark.counts.kernels, benchmark.checks, benchmark.weights")
    assert not loaded & {"asv_subtools_tpu", "asv_subtools_tpu_torch", "jax", "jaxlib", "flax"}
