"""Waveform signal processing (the port's own numpy/scipy copy).

Counterpart: asv_subtools_tpu/data/signal.py, behaviour unchanged
(parity: pytorch/libs/egs/signal_processing.py). Host-side: de_silence
energy VAD (:13), amplitude compute / normalize / rescale (:57-197), FFT
convolve (:198), reverberate (:321), notch_filter (:414). These run in
the input pipeline workers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import signal as sps


def de_silence(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    win_len: float = 0.1,
    min_eng: float = 50.0,
    retry_times: int = 1,
    force_output: bool = True,
) -> np.ndarray:
    """Drop low-energy windows (signal_processing.py:13-55): frame the wav
    into win_len windows, keep those with mean abs energy >= min_eng,
    halving the threshold up to retry_times if everything got removed."""
    x = np.asarray(waveform, np.float32)
    n = int(win_len * sample_rate)
    if n <= 0 or len(x) < n:
        return x
    usable = len(x) - len(x) % n
    frames = x[:usable].reshape(-1, n)
    tail = x[usable:]
    eng = np.abs(frames).mean(axis=1)
    thresh = min_eng
    for _ in range(retry_times + 1):
        keep = eng >= thresh
        if keep.any():
            out = frames[keep].reshape(-1)
            if len(tail) and np.abs(tail).mean() >= thresh:
                out = np.concatenate([out, tail])
            return out
        thresh /= 2.0
    return x if force_output else x[:0]


def compute_amplitude(
    waveform: np.ndarray, amp_type: str = "avg", scale: str = "linear"
) -> float:
    """Mean-abs or peak amplitude, linear or dB (signal_processing.py:57)."""
    if amp_type == "avg":
        amp = float(np.mean(np.abs(waveform)))
    elif amp_type == "peak":
        amp = float(np.max(np.abs(waveform)))
    else:
        raise ValueError(amp_type)
    if scale == "linear":
        return amp
    if scale == "dB":
        return 20.0 * np.log10(max(amp, 1e-14))
    raise ValueError(scale)


def normalize_amplitude(waveform: np.ndarray, amp_type: str = "avg") -> np.ndarray:
    amp = compute_amplitude(waveform, amp_type)
    return waveform / max(amp, 1e-14)


def rescale_amplitude(
    waveform: np.ndarray, target_lvl: float, amp_type: str = "avg", scale: str = "linear"
) -> np.ndarray:
    """Rescale to a target level (linear amp or dB)."""
    x = normalize_amplitude(waveform, amp_type)
    if scale == "linear":
        return x * target_lvl
    if scale == "dB":
        return x * (10 ** (target_lvl / 20.0))
    raise ValueError(scale)


def convolve1d(waveform: np.ndarray, kernel: np.ndarray, mode: str = "full") -> np.ndarray:
    """FFT convolution (signal_processing.py:198-320 uses FFT for speed)."""
    return sps.fftconvolve(waveform, kernel, mode=mode)


def reverberate(
    waveform: np.ndarray, rir: np.ndarray, rescale_amp: str = "avg"
) -> np.ndarray:
    """Convolve with a room impulse response, preserving amplitude and
    aligning to the RIR's direct path (signal_processing.py:321-393).

    The reference's convolve1d(use_fft=True, rotation_index=direct)
    multiplies unpadded rFFTs — a CIRCULAR convolution with the kernel
    rotated so the direct path lands at lag zero; the tail wraps around
    to the start. Mirrored exactly (speechbrain semantics)."""
    x = np.asarray(waveform, np.float64)
    n = len(x)
    k = np.asarray(rir, np.float64)[:n]
    direct = int(np.argmax(np.abs(k)))
    k_rot = np.concatenate([k[direct:], np.zeros(n - len(k)), k[:direct]])
    orig_amp = compute_amplitude(x, rescale_amp)
    wet = np.fft.irfft(np.fft.rfft(x) * np.fft.rfft(k_rot), n=n)
    wet_amp = compute_amplitude(wet, rescale_amp)
    return (wet * (orig_amp / max(wet_amp, 1e-14))).astype(np.float32)


def notch_filter(
    notch_freq: float, filter_width: int = 101, notch_width: float = 0.05
) -> np.ndarray:
    """FIR band-rejection kernel (signal_processing.py:414-471), used by
    DropFreq. notch_freq in [0, 1] (fraction of Nyquist)."""
    pad = filter_width // 2
    inputs = np.arange(filter_width) - pad
    notch_freq += notch_width

    def sinc(x):
        return np.sinc(x / np.pi)

    # torch.blackman_window is PERIODIC by default (np.blackman(N+1)[:-1]),
    # unlike numpy's symmetric np.blackman(N) — reference :459-465
    window = np.blackman(filter_width + 1)[:-1]
    hlpf = sinc(3.0 * (notch_freq - notch_width) * inputs)
    hlpf *= window
    hlpf /= hlpf.sum()
    hhpf = sinc(3.0 * (notch_freq + notch_width) * inputs)
    hhpf *= window
    hhpf /= -hhpf.sum()
    hhpf[pad] += 1.0
    return hlpf + hhpf


def speed_perturb(
    waveform: np.ndarray, speed: float, sample_rate: int = 16000
) -> np.ndarray:
    """Resample-based speed perturbation (PreSpeedPerturb processor.py:177;
    sox speed semantics: output length = len/speed)."""
    if speed == 1.0:
        return waveform
    # resample_poly with up/down derived from speed ratio
    from fractions import Fraction

    frac = Fraction(1.0 / speed).limit_denominator(1000)
    return sps.resample_poly(waveform, frac.numerator, frac.denominator).astype(
        np.float32
    )


def resample(
    waveform: np.ndarray, orig_freq: int, new_freq: int
) -> np.ndarray:
    """Polyphase resampling (parity: Resample speech_augment.py:1293)."""
    if orig_freq == new_freq:
        return waveform
    from math import gcd

    g = gcd(orig_freq, new_freq)
    return sps.resample_poly(waveform, new_freq // g, orig_freq // g).astype(np.float32)


def overlap_and_add(frames: np.ndarray, frame_step: int) -> np.ndarray:
    """Inverse framing (signal_processing.py:472-570)."""
    n_frames, frame_len = frames.shape
    out_len = (n_frames - 1) * frame_step + frame_len
    out = np.zeros(out_len, frames.dtype)
    for i in range(n_frames):
        out[i * frame_step : i * frame_step + frame_len] += frames[i]
    return out
