"""Kaldi-compatible log-mel fbank and utterance CMVN as torch functions.

Counterpart: asv_subtools_tpu/features/functional.py:51-335 and 634-663.
This is the golden code that the fused fbank kernel (fused_fbank.py) is
held against. Per-config constants (window, mel filterbank, DFT) are
computed on the host in float64 numpy and handed to the device as float32,
as the JAX package does. The spectrum is the "gemm" mode: two real matrix
products against the DFT cosine and sine matrices.

Supported: snip_edges=True and dither=0, the extraction path.
Spec: kaldifeat feature-window.cc, mel-computations.cc, feature-fbank.cc.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from .config import EPSILON, FbankOptions, FrameOptions, MelOptions, mel_scale


@functools.lru_cache(maxsize=None)
def feature_window(opts: FrameOptions) -> np.ndarray:
    """Window function vector, shape [window_size] float32."""
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    wt = opts.window_type
    if wt == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif wt == "sine":
        w = np.sin(0.5 * a * i)
    elif wt == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif wt == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif wt == "rectangular":
        w = np.ones_like(i)
    elif wt == "blackman":
        w = (
            opts.blackman_coeff
            - 0.5 * np.cos(a * i)
            + (0.5 - opts.blackman_coeff) * np.cos(2 * a * i)
        )
    else:
        raise ValueError(f"Invalid window type {wt!r}")
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_banks(mel_opts: MelOptions, frame_opts: FrameOptions) -> np.ndarray:
    """Mel filterbank matrix, shape [num_fft_bins, num_bins] float32.

    num_fft_bins = padded_window_size // 2 (the highest rfft bin is
    dropped, matching the reference fbank path). No VTLN warp.
    """
    num_bins = mel_opts.num_bins
    if num_bins < 3:
        raise ValueError("Must have at least 3 mel bins")
    padded = frame_opts.padded_window_size
    if padded % 2 != 0:
        raise ValueError("padded window size must be even")
    num_fft_bins = padded // 2
    nyquist = 0.5 * frame_opts.samp_freq

    low_freq = mel_opts.low_freq
    high_freq = mel_opts.high_freq if mel_opts.high_freq > 0 else nyquist + mel_opts.high_freq
    if not (0 <= low_freq < nyquist and 0 < high_freq <= nyquist and low_freq < high_freq):
        raise ValueError(f"Bad low/high freq {low_freq}/{high_freq} vs nyquist {nyquist}")

    fft_bin_width = frame_opts.samp_freq / padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    fft_mels = np.array([mel_scale(fft_bin_width * i) for i in range(num_fft_bins)])
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        w = np.where(fft_mels <= center, up, down)
        w = np.where((fft_mels > left) & (fft_mels < right), w, 0.0)
        if not np.any(w > 0):
            raise ValueError("num_mel_bins too large for this window size")
        bins[b] = w
    return bins.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrices(padded_window_size: int, num_bins_keep: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cosine/sine matrices [padded_window_size, num_bins_keep]:
    power[k] = (x @ C)[k]^2 + (x @ S)[k]^2 equals |rfft(x)[k]|^2."""
    n = padded_window_size
    k = np.arange(num_bins_keep)[None, :]
    t = np.arange(n)[:, None]
    ang = 2.0 * math.pi * t * k / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def check_extraction_options(opts: FrameOptions) -> None:
    if opts.dither != 0.0 or not opts.snip_edges:
        raise ValueError("the port supports dither=0 and snip_edges=True only")


def frame_signal(wave: torch.Tensor, opts: FrameOptions) -> torch.Tensor:
    """Slice waveforms [..., num_samples] into frames [..., num_frames, window_size]."""
    check_extraction_options(opts)
    num_frames = opts.num_frames(wave.shape[-1])
    if num_frames <= 0:
        raise ValueError(f"waveform too short: {wave.shape[-1]} samples")
    frames = wave.unfold(-1, opts.window_size, opts.window_shift)
    return frames[..., :num_frames, :]


def _process_window(
    frames: torch.Tensor, opts: FrameOptions, *, need_raw_energy: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """DC-remove / raw-energy / preemphasis / window / pad (dither=0).

    frames: [..., num_frames, window_size] (Kaldi int16 sample scale).
    Returns (padded_frames [..., num_frames, padded_window_size], raw_log_energy).
    """
    check_extraction_options(opts)
    frames = frames.to(torch.float32)
    if opts.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    raw_log_energy = torch.zeros(frames.shape[:-1], dtype=torch.float32, device=frames.device)
    if need_raw_energy:
        raw_log_energy = torch.log(torch.clamp_min((frames * frames).sum(-1), EPSILON))
    if opts.preemph_coeff != 0.0:
        first = frames[..., :1] * (1.0 - opts.preemph_coeff)
        rest = frames[..., 1:] - opts.preemph_coeff * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    frames = frames * torch.as_tensor(feature_window(opts), device=frames.device)
    pad = opts.padded_window_size - opts.window_size
    if pad > 0:
        frames = torch.nn.functional.pad(frames, (0, pad))
    return frames, raw_log_energy


def power_spectrum(padded_frames: torch.Tensor, opts: FrameOptions, *, keep_bins: int,
                   fft_mode: str = "gemm") -> torch.Tensor:
    """Power spectrum of windowed frames (first `keep_bins` rfft bins).

    fft_mode="gemm" (the default): two real GEMMs against the DFT matrices
    (the JAX "gemm" mode). "rfft": an FFT in float64, the power cast back
    to float32 (the JAX package's numpy host path, whose np.fft computes
    in float64)."""
    if fft_mode == "rfft":
        spec = torch.fft.rfft(padded_frames.to(torch.float64), dim=-1)
        return (spec.real * spec.real + spec.imag * spec.imag).to(torch.float32)[..., :keep_bins]
    if fft_mode != "gemm":
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    c, s = dft_matrices(opts.padded_window_size, keep_bins)
    dev = padded_frames.device
    re = padded_frames @ torch.as_tensor(c, device=dev)
    im = padded_frames @ torch.as_tensor(s, device=dev)
    return re * re + im * im


def compute_fbank(wave: torch.Tensor, opts: FbankOptions = FbankOptions(), *, fft_mode: str = "gemm") -> torch.Tensor:
    """Log-mel filterbank. wave [..., num_samples] -> [..., num_frames, dim].
    ``fft_mode`` as in :func:`power_spectrum`.

    Parity: reference runtime/kaldifeat/csrc/feature-fbank.cc:46-108.
    """
    fo = opts.frame_opts
    frames = frame_signal(wave, fo)
    need_raw = opts.use_energy and opts.raw_energy
    padded, raw_log_energy = _process_window(frames, fo, need_raw_energy=need_raw)
    if opts.use_energy and not opts.raw_energy:
        raw_log_energy = torch.log(torch.clamp_min((padded * padded).sum(-1), EPSILON))

    keep = fo.padded_window_size // 2  # highest bin dropped
    spectrum = power_spectrum(padded, fo, keep_bins=keep, fft_mode=fft_mode)
    if not opts.use_power:
        spectrum = torch.sqrt(spectrum)
    mel = spectrum @ torch.as_tensor(mel_banks(opts.mel_opts, fo), device=wave.device)
    if opts.use_log_fbank:
        mel = torch.log(torch.clamp_min(mel, EPSILON))
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            raw_log_energy = torch.clamp_min(raw_log_energy, math.log(opts.energy_floor))
        e = raw_log_energy[..., None]
        mel = torch.cat([mel, e] if opts.htk_compat else [e, mel], dim=-1)
    return mel


def cmvn_utterance(
    feats: torch.Tensor,
    *,
    norm_means: bool = True,
    norm_vars: bool = False,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-10,
) -> torch.Tensor:
    """Per-utterance mean (and optional variance) normalisation.

    feats [..., T, D]; mask [..., T] True for valid frames. Counterpart:
    asv_subtools_tpu/features/functional.py:634-663.
    """
    if mask is None:
        mean = feats.mean(dim=-2, keepdim=True)
        if norm_vars:
            var = feats.var(dim=-2, keepdim=True, unbiased=False)
    else:
        m = mask.to(feats.dtype)[..., None]
        count = torch.clamp_min(m.sum(dim=-2, keepdim=True), 1.0)
        mean = (feats * m).sum(dim=-2, keepdim=True) / count
        if norm_vars:
            var = ((feats - mean) ** 2 * m).sum(dim=-2, keepdim=True) / count
    out = feats
    if norm_means:
        out = out - mean
    if norm_vars:
        out = out / torch.sqrt(var + eps)
    return out
