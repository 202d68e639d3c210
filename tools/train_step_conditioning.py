"""How far an f32 train step of ECAPA-TDNN sits from the f64 step, on the
card and on the CPU, over seeds, heads and cuDNN settings.

Run from the repository root on a machine with a CUDA card:

    python3 tools/train_step_conditioning.py

The case is asv_subtools_tpu_torch/train/step_check.py's (SpeakerNet with
EcapaTdnn(channels=256), B=8 x 2 s, 80 bins, 5994 classes, one SGD step of
lr 0.1 from seeded random weights). TF32 is off. It prints:

1. the f32 convolutions' error on the card against f64, and the
   convolution kernels cuDNN runs in the f32 step (their names carry the
   algorithm);
2. for each (data, weights) seed and each head (the sub-centre top-k AAM
   head, the sub-centre head with one centre and no top-k, the AAM margin
   softmax): against the f64 step on the plain front end's features, the
   worst leaf update (over that leaf's update norm), the worst BN running
   statistic and loss and grad_norm, for the f32 step on the CPU and on
   the card, both on waves (the front end in the step: the plain version
   on the CPU, the fbank kernel in its f32 mode on the card), and for the
   card's f32 step on the same features with cuDNN as it is, with
   ``cudnn.deterministic`` and with cuDNN off;
3. the f64 step's worst leaf when uniform noise of 2e-6 (the f32 fbank
   kernel's distance from its plain version) is added to the features.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from asv_subtools_tpu_torch.train.step_check import (AAM, SUBCENTER_TOPK, modulated_waves, plain_features, rel,
                                                     sgd_step, worst_leaf)

HEADS = {
    "sub-centre top-k": SUBCENTER_TOPK,
    "one centre, no top-k": ("margin_softmax_v1", {"method": "aam", "m": 0.2, "s": 30}),
    "aam margin softmax": AAM,
}
SEEDS = ((1, 0), (30, 32), (5, 7), (11, 3), (42, 17), (8, 99))  # (data, weights)


@contextlib.contextmanager
def cudnn_mode(mode: str):
    old = torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic
    torch.backends.cudnn.enabled = mode != "off"
    torch.backends.cudnn.deterministic = mode == "deterministic"
    try:
        yield
    finally:
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = old


def conv_errors() -> str:
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, 198, generator=g, dtype=torch.float64)
    w = torch.randn(256, 256, 3, generator=g, dtype=torch.float64) / 30
    xc, wc = x.float().cuda().requires_grad_(), w.float().cuda().requires_grad_()
    x6, w6 = x.clone().requires_grad_(), w.clone().requires_grad_()
    yc, y6 = F.conv1d(xc, wc, padding=2, dilation=2), F.conv1d(x6, w6, padding=2, dilation=2)
    gy = torch.randn(y6.shape, generator=g, dtype=torch.float64)
    yc.backward(gy.float().cuda())
    y6.backward(gy)
    err = lambda a, b: float((a.detach().double().cpu() - b.detach()).abs().max() / b.detach().abs().max())
    return (f"forward {err(yc, y6):.2e}, data gradient {err(xc.grad, x6.grad):.2e}, "
            f"weight gradient {err(wc.grad, w6.grad):.2e}")


def conv_kernels(x, y) -> str:
    """The convolution kernels of one f32 step on the card, with counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sgd_step("cuda", torch.float32, x, y)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sgd_step("cuda", torch.float32, x, y)
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        low = e.name.lower()
        if e.device_type == DeviceType.CUDA and any(w in low for w in ("conv", "cudnn", "xmma", "fprop", "dgrad",
                                                                      "wgrad", "winograd", "fft", "gemm")):
            names[e.name] = names.get(e.name, 0) + 1
    return "\n".join(f"  x{n:<3d} {name[:150]}" for name, n in sorted(names.items(), key=lambda kv: -kv[1]))


def reading(r, ref) -> str:
    e, leaf, _ = worst_leaf(r.updates, ref.updates)
    s, stat, _ = worst_leaf(r.batch_stats, ref.batch_stats)
    return (f"leaf {e:.2e} ({leaf.replace('backbone.', '')}), stats {s:.2e} ({stat.replace('backbone.', '')}), "
            f"loss {rel(r.metrics['loss'], ref.metrics['loss']):.1e}, "
            f"grad_norm {rel(r.metrics['grad_norm'], ref.metrics['grad_norm']):.1e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_conditioning: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(f"f32 conv1d on the card against f64 (max error over max magnitude): {conv_errors()}", flush=True)
    waves, y = modulated_waves(8, SEEDS[0][0])
    print(f"convolution kernels of one f32 step on the card (data {SEEDS[0][0]}, weights 0):\n"
          f"{conv_kernels(plain_features(waves), y)}", flush=True)
    worst = {}
    for data_seed, weight_seed in SEEDS:
        waves, y = modulated_waves(8, data_seed)
        x = plain_features(waves)
        for head_name, head in HEADS.items():
            ref = sgd_step("cpu", torch.float64, x, y, head, weight_seed)
            runs = {"cpu f32 waves": sgd_step("cpu", torch.float32, waves, y, head, weight_seed, wave_input=True),
                    "card f32 waves": sgd_step("cuda", torch.float32, waves, y, head, weight_seed, wave_input=True)}
            for mode in ("as is", "deterministic", "off"):
                with cudnn_mode(mode):
                    runs[f"card f32 feats cudnn {mode}"] = sgd_step("cuda", torch.float32, x, y, head, weight_seed)
            for what, r in runs.items():
                e = worst_leaf(r.updates, ref.updates)[0]
                worst[what] = max(worst.get(what, 0.0), e)
            print(f"data {data_seed} weights {weight_seed}, {head_name}:\n"
                  + "\n".join(f"  {what}: {reading(r, ref)}" for what, r in runs.items()), flush=True)
    print("worst leaf over every seed and head: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()), flush=True)
    waves, y = modulated_waves(8, SEEDS[0][0])
    x = plain_features(waves)
    ref = sgd_step("cpu", torch.float64, x, y, AAM, 0)
    noise = (2 * torch.rand(x.shape, generator=torch.Generator().manual_seed(7)) - 1) * 2e-6
    e, leaf, whole = worst_leaf(sgd_step("cpu", torch.float64, x + noise, y, AAM, 0).updates, ref.updates)
    print(f"f64 step with features moved by uniform noise of 2e-6: worst leaf {e:.2e} ({leaf}), whole {whole:.2e}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
