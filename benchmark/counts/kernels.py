"""Operations and bytes of the port's hand-written kernels at a launch's
shapes: each input byte read once, each output byte written once.

Frozen copies of the arithmetic the bring-up used (``chip_smoke.py``'s
K1, K2 and K3 timings and ``bound_ms``), so that a later change to the
program cannot change what its kernels are held to.
"""

from __future__ import annotations

from typing import Tuple

from ..reference import fbank

# K1: the folded DFT is [window, 2 * 256] in bf16 and the 80-bin mel
# filters hold this many non-zero weights (Kaldi's filters on 256 bins)
DFT_COLUMNS = fbank.FFT


def mel_nonzeros(num_bins: int) -> int:
    return int((fbank.mel_matrix(num_bins) != 0).sum())


def k1(batch: int, samples: int, num_bins: int = 80) -> Tuple[float, float]:
    """Fused fbank over a [batch, samples] f32 wave -> [batch, T, bins] f32:
    the framed product with the folded DFT and the mel product."""
    t = fbank.num_frames(samples)
    flops = 2.0 * batch * t * (fbank.WINDOW * DFT_COLUMNS + mel_nonzeros(num_bins))
    nbytes = 4.0 * batch * samples + 4.0 * batch * t * num_bins + 2.0 * fbank.WINDOW * DFT_COLUMNS
    return flops, nbytes


def k1_frame_flops(num_bins: int = 80) -> float:
    """K1's operations per frame: the DFT and mel products."""
    return 2.0 * (fbank.WINDOW * DFT_COLUMNS + mel_nonzeros(num_bins))


def k2(batch: int, frames: int, channels: int, bottleneck: int = 128) -> Tuple[float, float]:
    """Attentive statistics pooling over bf16 x [batch, frames, channels]
    -> [batch, 2 * channels] f32: the two 1x1 products of the attention."""
    flops = 2.0 * 2 * batch * frames * channels * bottleneck
    nbytes = 2.0 * batch * frames * channels + 2 * 4.0 * channels * bottleneck + batch * frames \
        + 4.0 * 2 * batch * channels
    return flops, nbytes


def k3(batch: int, frames: int, channels: int, scale: int = 8) -> Tuple[float, float]:
    """One Res2Net chain over bf16 x [batch, frames, channels]: seven k=3
    convs of width h = channels / scale, x in and out, the bf16 weights
    and three f32 vectors a stage."""
    h, n = channels // scale, scale - 1
    flops = 2.0 * batch * frames * n * 3 * h * h
    nbytes = 2 * 2.0 * batch * frames * channels + 2.0 * n * 3 * h * h + 3 * 4.0 * n * h
    return flops, nbytes
