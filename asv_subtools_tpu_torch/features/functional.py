"""Kaldi-compatible log-mel fbank, energy VAD and CMVN as torch functions.

Counterpart: asv_subtools_tpu/features/functional.py:51-335 and 583-717.
This is the golden code that the fused fbank kernel (fused_fbank.py) is
held against. Per-config constants (window, mel filterbank, DFT) are
computed on the host in float64 numpy and handed to the device as float32,
as the JAX package does. The spectrum is the "gemm" mode (two real matrix
products against the DFT cosine and sine matrices) or an rfft in float64.

The plain front end takes Kaldi's framing options: dither (gaussian noise
of std ``dither`` per sample, drawn only when a generator is given: a
numpy ``Generator`` on the host, as JAX's numpy path draws it, or a
``torch.Generator`` on the tensor's device) and ``snip_edges=False``
(frames centred on multiples of the shift, the wave padded by reflection).
The fused kernel takes neither (check_extraction_options), as JAX's
fused_fbank does not. The Kaldi-style host front end's other steps:
energy VAD (compute_vad_energy), voiced-frame selection
(select_voiced_frames) and sliding CMVN (cmvn_sliding).
Spec: kaldifeat feature-window.cc, mel-computations.cc, feature-fbank.cc;
Kaldi compute-vad and apply-cmvn-sliding.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import numpy as np
import torch

from .config import EPSILON, FbankOptions, FrameOptions, MelOptions, VadOptions, mel_scale


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
    """The fused fbank's options: dither 0 and snip_edges (JAX
    pallas_fbank.py:254-255 rejects the others too)."""
    if opts.dither != 0.0 or not opts.snip_edges:
        raise ValueError("the fused fbank supports dither=0 and snip_edges=True only")


def frame_signal(wave: torch.Tensor, opts: FrameOptions) -> torch.Tensor:
    """Slice waveforms [..., num_samples] into frames [..., num_frames,
    window_size]. With ``snip_edges=False`` the wave is first extended by
    reflection at both ends (JAX functional.py:203-224)."""
    num_samples = wave.shape[-1]
    shift, length = opts.window_shift, opts.window_size
    num_frames = opts.num_frames(num_samples)
    if num_frames <= 0:
        raise ValueError(f"waveform too short: {num_samples} samples")
    if not opts.snip_edges:
        num_pad = (num_frames - 1) * shift + length - num_samples
        left = (length - shift) // 2
        right = num_pad - left
        wave = torch.cat([wave[..., :left].flip(-1), wave, wave[..., num_samples - right:].flip(-1)], dim=-1)
    return wave.unfold(-1, length, shift)[..., :num_frames, :]


def _dither_noise(shape: torch.Size, dither: float, rng: Any, device: torch.device) -> torch.Tensor:
    """Gaussian noise of std ``dither``: from a numpy Generator as JAX's
    host path draws it (f64 normals times dither, cast to f32), or from a
    torch.Generator on ``device``."""
    if isinstance(rng, np.random.Generator):
        return torch.from_numpy((dither * rng.normal(size=tuple(shape))).astype(np.float32)).to(device)
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device=device, dtype=torch.float32) * dither
    raise TypeError(f"dither needs a numpy Generator or a torch.Generator, got {type(rng).__name__}")


def _process_window(
    frames: torch.Tensor, opts: FrameOptions, *, rng: Any = None, need_raw_energy: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dither / DC-remove / raw-energy / preemphasis / window / pad.

    frames: [..., num_frames, window_size] (Kaldi int16 sample scale). The
    dither is drawn only when ``rng`` is given (JAX functional.py:236-238).
    Returns (padded_frames [..., num_frames, padded_window_size], raw_log_energy).
    """
    frames = frames.to(torch.float32)
    if opts.dither != 0.0 and rng is not None:
        frames = frames + _dither_noise(frames.shape, opts.dither, rng, frames.device)
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


def compute_fbank(wave: torch.Tensor, opts: FbankOptions = FbankOptions(), *, rng: Any = None,
                  fft_mode: str = "gemm") -> torch.Tensor:
    """Log-mel filterbank. wave [..., num_samples] -> [..., num_frames, dim].
    ``fft_mode`` as in :func:`power_spectrum`; ``rng`` draws the dither
    (see :func:`_dither_noise`; none without it, as in JAX).

    Parity: reference runtime/kaldifeat/csrc/feature-fbank.cc:46-108.
    """
    fo = opts.frame_opts
    frames = frame_signal(wave, fo)
    need_raw = opts.use_energy and opts.raw_energy
    padded, raw_log_energy = _process_window(frames, fo, rng=rng, need_raw_energy=need_raw)
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


def compute_vad_energy(log_energy: torch.Tensor, opts: VadOptions = VadOptions(),
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame-level energy VAD -> float {0, 1} per frame (Kaldi compute-vad;
    JAX functional.py:583-630). log_energy [..., T]: the frames' log
    energies (an energy column of the features); ``mask`` [..., T] marks
    valid frames of a padded batch (True = valid), whose mean alone sets
    the threshold and which alone vote."""
    t_axis = log_energy.shape[-1]
    if mask is None:
        valid = torch.ones_like(log_energy, dtype=torch.bool)
        count = float(t_axis)
    else:
        valid = mask.to(torch.bool)
        count = torch.clamp_min(valid.sum(-1, keepdim=True).to(torch.float32), 1.0)
    validf = valid.to(torch.float32)
    threshold = opts.energy_threshold
    if opts.energy_mean_scale != 0.0:
        mean = torch.where(valid, log_energy, 0.0).sum(-1, keepdim=True) / count
        threshold = threshold + opts.energy_mean_scale * mean
    above = torch.where(valid, (log_energy > threshold).to(torch.float32), 0.0)
    ctx = opts.frames_context
    if ctx == 0:
        return above * validf
    # windowed vote over 2 ctx + 1 frames: voiced where num >= den * proportion
    num, den = (_window_sum(v, ctx) for v in (above, validf))
    return (num >= den * opts.proportion_threshold).to(torch.float32) * validf


def _window_sum(x: torch.Tensor, ctx: int) -> torch.Tensor:
    """The sum over frames t - ctx .. t + ctx along the last axis, zeros past the ends."""
    t = x.shape[-1]
    xp = torch.nn.functional.pad(x, (ctx, ctx))
    out = torch.zeros_like(x)
    for i in range(2 * ctx + 1):
        out = out + xp[..., i:i + t]
    return out


def cmvn_sliding(feats: torch.Tensor, *, window: int = 300, norm_vars: bool = False,
                 eps: float = 1e-10) -> torch.Tensor:
    """Sliding-window CMVN (Kaldi apply-cmvn-sliding, center=true; JAX
    functional.py:666-700): frame t is normalised by the frames of a
    ``window``-frame window centred on it and shifted to lie inside the
    utterance; an utterance of at most ``window`` frames gets
    :func:`cmvn_utterance`. feats [..., T, D]."""
    t_len = feats.shape[-2]
    if t_len <= window:
        return cmvn_utterance(feats, norm_vars=norm_vars, eps=eps)
    t = torch.arange(t_len, device=feats.device)
    start = torch.clamp(t - window // 2, 0, t_len - window)
    end = start + window

    def window_sums(x):
        cs = torch.cat([torch.zeros_like(x[..., :1, :]), torch.cumsum(x, dim=-2)], dim=-2)
        return cs.index_select(-2, end) - cs.index_select(-2, start)

    mean = window_sums(feats) / float(window)
    out = feats - mean
    if norm_vars:
        var = window_sums(feats * feats) / float(window) - mean * mean
        out = out / torch.sqrt(torch.clamp_min(var, eps))
    return out


def select_voiced_frames(feats: torch.Tensor, voiced: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Voiced frames moved to the front in order (a stable partition),
    and the mask of the voiced count: (feats [..., T, D], mask [..., T])
    (Kaldi select-voiced-frames at a static shape; JAX
    functional.py:703-717)."""
    t_len = feats.shape[-2]
    is_voiced = voiced > 0.5
    key = torch.where(is_voiced, 0, 1) * t_len + torch.arange(t_len, device=feats.device)
    order = torch.argsort(key, dim=-1)
    gathered = feats.gather(-2, order[..., None].expand(*order.shape, feats.shape[-1]))
    count = is_voiced.sum(-1, keepdim=True)
    return gathered, torch.arange(t_len, device=feats.device) < count
