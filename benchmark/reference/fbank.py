"""Kaldi log-mel filterbank and utterance CMVN, in plain PyTorch.

Kaldi's ``compute-fbank-feats`` with the recipe's options: 16 kHz, 25 ms
windows every 10 ms (``snip_edges``), no dither, DC offset removed,
pre-emphasis 0.97, the povey window, a 512-point FFT, the power
spectrum, ``num_bins`` triangular mel filters from 20 Hz to Nyquist on
the first 256 bins (the Nyquist bin is dropped, as in Kaldi's
filterbank), the natural log floored at float32's epsilon. No energy.

:func:`features` is the front end of a padded batch: the fbank of every
frame of the padded wave, the mean over each row's valid frames
subtracted, and the padded frames zeroed. A row of n valid samples has
``max((n - 400) // 160 + 1, 1)`` valid frames.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
WINDOW = 400
SHIFT = 160
FFT = 512
PREEMPH = 0.97
LOW_HZ = 20.0
LOG_FLOOR = float(np.finfo(np.float32).eps)


def _mel(hz: float) -> float:
    return 1127.0 * math.log(1.0 + hz / 700.0)


@functools.lru_cache(maxsize=None)
def mel_matrix(num_bins: int) -> np.ndarray:
    """[FFT/2, num_bins] float64: Kaldi's triangular filters, equally
    spaced on the mel scale between 20 Hz and Nyquist."""
    bins = FFT // 2
    lo, hi = _mel(LOW_HZ), _mel(SAMPLE_RATE / 2)
    delta = (hi - lo) / (num_bins + 1)
    fft_mel = np.array([_mel(SAMPLE_RATE / FFT * i) for i in range(bins)])
    out = np.zeros((bins, num_bins))
    for b in range(num_bins):
        left, centre, right = lo + b * delta, lo + (b + 1) * delta, lo + (b + 2) * delta
        up = (fft_mel - left) / (centre - left)
        down = (right - fft_mel) / (right - centre)
        w = np.where(fft_mel <= centre, up, down)
        out[:, b] = np.where((fft_mel > left) & (fft_mel < right), w, 0.0)
    return out


@functools.lru_cache(maxsize=None)
def povey_window() -> np.ndarray:
    i = np.arange(WINDOW, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / (WINDOW - 1))) ** 0.85


def num_frames(samples: int) -> int:
    return 1 + (samples - WINDOW) // SHIFT if samples >= WINDOW else 0


def fbank(wave: torch.Tensor, num_bins: int = 80) -> torch.Tensor:
    """wave [B, S] float32 -> log-mel [B, T, num_bins] float32."""
    frames = wave.unfold(-1, WINDOW, SHIFT)
    frames = frames - frames.mean(-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - PREEMPH * prev) * torch.as_tensor(povey_window(), dtype=wave.dtype, device=wave.device)
    spec = torch.fft.rfft(frames, n=FFT)[..., : FFT // 2]
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.as_tensor(mel_matrix(num_bins), dtype=wave.dtype, device=wave.device)
    return torch.log(torch.clamp_min(mel, LOG_FLOOR))


def features(wave: torch.Tensor, valid: Optional[torch.Tensor] = None,
             num_bins: int = 80) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """wave [B, S] with ``valid`` samples a row ([B] ints, or None for
    whole rows) -> (CMVN'd log-mel [B, T, bins], frame mask [B, T] or
    None)."""
    feats = fbank(wave, num_bins)
    if valid is None:
        return feats - feats.mean(1, keepdim=True), None
    n = torch.clamp_min(torch.div(valid - WINDOW, SHIFT, rounding_mode="floor") + 1, 1)
    fmask = torch.arange(feats.shape[1], device=feats.device)[None, :] < n[:, None]
    m = fmask.to(feats.dtype)[..., None]
    mean = (feats * m).sum(1, keepdim=True) / torch.clamp_min(m.sum(1, keepdim=True), 1.0)
    return (feats - mean) * m, fmask
