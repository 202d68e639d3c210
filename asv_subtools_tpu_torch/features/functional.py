"""Kaldi-compatible host features (fbank, MFCC, PLP, spectrogram), energy
VAD and CMVN as torch functions.

Counterpart: asv_subtools_tpu/features/functional.py. This is the golden
code that the fused fbank kernel (fused_fbank.py) is held against.
Per-config constants (window, mel filterbank with the optional VTLN warp,
DFT, DCT, lifter, equal loudness, IDFT bases) are computed on the host in
float64 numpy and handed to the device as float32, as the JAX package
does, or as float64 when the wave is float64: a float64 wave runs every
step in float64. The spectrum is the "gemm" mode (two real matrix products
against the DFT cosine and sine matrices) or an rfft in float64. Every
function takes a batch of waves [..., num_samples] on any device.

The plain front end takes Kaldi's framing options: dither (gaussian noise
of std ``dither`` per sample, drawn only when a generator is given: a
numpy ``Generator`` on the host, as JAX's numpy path draws it, or a
``torch.Generator`` on the tensor's device) and ``snip_edges=False``
(frames centred on multiples of the shift, the wave padded by reflection).
The fused kernel takes neither (check_extraction_options), as JAX's
fused_fbank does not. The Kaldi-style host front end's other steps:
energy VAD (compute_vad_energy), voiced-frame selection
(select_voiced_frames) and sliding CMVN (cmvn_sliding).
Spec: kaldifeat feature-window.cc, mel-computations.cc, feature-fbank.cc,
feature-mfcc.cc, feature-plp.cc, feature-spectrogram.cc; Kaldi compute-vad
and apply-cmvn-sliding.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import numpy as np
import torch

from .config import (EPSILON, FbankOptions, FrameOptions, MelOptions, MfccOptions, PlpOptions, SpectrogramOptions,
                     VadOptions, inverse_mel_scale, mel_scale)


def _const(table64: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A float64 host constant on ``like``'s device: rounded once to
    float32 (as JAX's constants are) unless ``like`` is float64."""
    if like.dtype != torch.float64:
        table64 = table64.astype(np.float32)
    return torch.from_numpy(table64).to(like.device)


@functools.lru_cache(maxsize=None)
def _feature_window64(opts: FrameOptions) -> np.ndarray:
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
    return w


def feature_window(opts: FrameOptions) -> np.ndarray:
    """Window function vector, shape [window_size] float32."""
    return _feature_window64(opts).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mel_banks64(mel_opts: MelOptions, frame_opts: FrameOptions, vtln_warp: float = 1.0) -> np.ndarray:
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
    vtln_low = mel_opts.vtln_low
    vtln_high = mel_opts.vtln_high + nyquist if mel_opts.vtln_high < 0 else mel_opts.vtln_high

    def warp_mel(mel):
        if vtln_warp == 1.0:
            return mel
        return _vtln_warp_mel(vtln_low, vtln_high, low_freq, high_freq, vtln_warp, mel)

    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    fft_mels = np.array([mel_scale(fft_bin_width * i) for i in range(num_fft_bins)])
    for b in range(num_bins):
        left = warp_mel(mel_low + b * mel_delta)
        center = warp_mel(mel_low + (b + 1) * mel_delta)
        right = warp_mel(mel_low + (b + 2) * mel_delta)
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        w = np.where(fft_mels <= center, up, down)
        w = np.where((fft_mels > left) & (fft_mels < right), w, 0.0)
        if not np.any(w > 0):
            raise ValueError("num_mel_bins too large for this window size")
        bins[b] = w
    return bins.T


def mel_banks(mel_opts: MelOptions, frame_opts: FrameOptions, vtln_warp: float = 1.0) -> np.ndarray:
    """Mel filterbank matrix, shape [num_fft_bins, num_bins] float32, with
    the bins' edges moved by the VTLN warp factor ``vtln_warp`` (1.0: no
    warp). num_fft_bins = padded_window_size // 2 (the highest rfft bin is
    dropped, matching the reference fbank/mfcc path)."""
    return _mel_banks64(mel_opts, frame_opts, vtln_warp).astype(np.float32)


def _vtln_warp_freq(vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq, warp, freq):
    """Kaldi's piecewise-linear VTLN warp of one frequency
    (mel-computations.cc VtlnWarpFreq): scaled by 1 / warp between the
    cutoffs, linear to the band's edges outside them."""
    if freq < low_freq or freq > high_freq:
        return freq
    l = vtln_low_cutoff * max(1.0, warp)
    h = vtln_high_cutoff * min(1.0, warp)
    scale = 1.0 / warp
    fl, fh = scale * l, scale * h
    scale_left = (fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - fh) / (high_freq - h)
    if freq < l:
        return low_freq + scale_left * (freq - low_freq)
    if freq < h:
        return scale * freq
    return high_freq + scale_right * (freq - high_freq)


def _vtln_warp_mel(vtln_low, vtln_high, low_freq, high_freq, warp, mel):
    return mel_scale(_vtln_warp_freq(vtln_low, vtln_high, low_freq, high_freq, warp, inverse_mel_scale(mel)))


@functools.lru_cache(maxsize=None)
def _dct64(num_rows: int, num_cols: int) -> np.ndarray:
    n = num_cols
    m = np.zeros((num_rows, n), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / n)
    for k in range(1, num_rows):
        m[k, :] = math.sqrt(2.0 / n) * np.cos(math.pi / n * k * (np.arange(n) + 0.5))
    return m.T


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix rows 0..num_rows-1, shape [num_cols,
    num_rows] float32 (transposed, ready for ``mel @ dct``)."""
    return _dct64(num_rows, num_cols).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lifter64(q: float, num_ceps: int) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * q * np.sin(math.pi * i / q)


def lifter_coeffs(q: float, num_ceps: int) -> np.ndarray:
    return _lifter64(q, num_ceps).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft64(padded_window_size: int, num_bins_keep: int) -> tuple[np.ndarray, np.ndarray]:
    n = padded_window_size
    k = np.arange(num_bins_keep)[None, :]
    t = np.arange(n)[:, None]
    ang = 2.0 * math.pi * t * k / n
    return np.cos(ang), -np.sin(ang)


def dft_matrices(padded_window_size: int, num_bins_keep: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cosine/sine matrices [padded_window_size, num_bins_keep]:
    power[k] = (x @ C)[k]^2 + (x @ S)[k]^2 equals |rfft(x)[k]|^2."""
    c, s = _dft64(padded_window_size, num_bins_keep)
    return c.astype(np.float32), s.astype(np.float32)


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


def _dither_noise(shape: torch.Size, dither: float, rng: Any, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian noise of std ``dither``: from a numpy Generator as JAX's
    host path draws it (f64 normals times dither, cast to the frames'
    type), or from a torch.Generator on ``device``."""
    if isinstance(rng, np.random.Generator):
        noise = dither * rng.normal(size=tuple(shape))
        return torch.from_numpy(noise if dtype == torch.float64 else noise.astype(np.float32)).to(device)
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device=device, dtype=dtype) * dither
    raise TypeError(f"dither needs a numpy Generator or a torch.Generator, got {type(rng).__name__}")


def _process_window(
    frames: torch.Tensor, opts: FrameOptions, *, rng: Any = None, need_raw_energy: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dither / DC-remove / raw-energy / preemphasis / window / pad.

    frames: [..., num_frames, window_size] (Kaldi int16 sample scale),
    computed in float32 (float64 frames stay float64). The dither is drawn
    only when ``rng`` is given (JAX functional.py:236-238).
    Returns (padded_frames [..., num_frames, padded_window_size], raw_log_energy).
    """
    frames = frames.to(torch.float64 if frames.dtype == torch.float64 else torch.float32)
    if opts.dither != 0.0 and rng is not None:
        frames = frames + _dither_noise(frames.shape, opts.dither, rng, frames.device, frames.dtype)
    if opts.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    raw_log_energy = torch.zeros(frames.shape[:-1], dtype=frames.dtype, device=frames.device)
    if need_raw_energy:
        raw_log_energy = _log_energy(frames)
    if opts.preemph_coeff != 0.0:
        first = frames[..., :1] * (1.0 - opts.preemph_coeff)
        rest = frames[..., 1:] - opts.preemph_coeff * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    frames = frames * _const(_feature_window64(opts), frames)
    pad = opts.padded_window_size - opts.window_size
    if pad > 0:
        frames = torch.nn.functional.pad(frames, (0, pad))
    return frames, raw_log_energy


def _log_energy(frames: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min((frames * frames).sum(-1), EPSILON))


def power_spectrum(padded_frames: torch.Tensor, opts: FrameOptions, *, keep_bins: int,
                   fft_mode: str = "gemm") -> torch.Tensor:
    """Power spectrum of windowed frames (first `keep_bins` rfft bins).

    fft_mode="gemm" (the default): two real GEMMs against the DFT matrices
    (the JAX "gemm" mode). "rfft": an FFT in float64, the power cast back
    to the frames' type (the JAX package's numpy host path, whose np.fft
    computes in float64)."""
    if fft_mode == "rfft":
        spec = torch.fft.rfft(padded_frames.to(torch.float64), dim=-1)
        return (spec.real * spec.real + spec.imag * spec.imag).to(padded_frames.dtype)[..., :keep_bins]
    if fft_mode != "gemm":
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    c, s = _dft64(opts.padded_window_size, keep_bins)
    re = padded_frames @ _const(c, padded_frames)
    im = padded_frames @ _const(s, padded_frames)
    return re * re + im * im


def _frames_and_energy(wave: torch.Tensor, fo: FrameOptions, use_energy: bool, raw_energy: bool, rng: Any):
    """Framed, windowed, padded frames and the log energy the options ask
    for: of the raw frames (after the DC removal) or of the windowed ones."""
    padded, log_energy = _process_window(frame_signal(wave, fo), fo, rng=rng,
                                         need_raw_energy=use_energy and raw_energy)
    if use_energy and not raw_energy:
        log_energy = _log_energy(padded)
    return padded, log_energy


def _floored(log_energy: torch.Tensor, energy_floor: float) -> torch.Tensor:
    return torch.clamp_min(log_energy, math.log(energy_floor)) if energy_floor > 0.0 else log_energy


def _set_first(feats: torch.Tensor, column: torch.Tensor) -> torch.Tensor:
    """feats with column 0 replaced by ``column`` ([..., T])."""
    return torch.cat([column[..., None].to(feats.dtype), feats[..., 1:]], dim=-1)


def compute_fbank(wave: torch.Tensor, opts: FbankOptions = FbankOptions(), *, rng: Any = None,
                  fft_mode: str = "gemm") -> torch.Tensor:
    """Log-mel filterbank. wave [..., num_samples] -> [..., num_frames, dim].
    ``fft_mode`` as in :func:`power_spectrum`; ``rng`` draws the dither
    (see :func:`_dither_noise`; none without it, as in JAX).

    Parity: reference runtime/kaldifeat/csrc/feature-fbank.cc:46-108.
    """
    fo = opts.frame_opts
    padded, log_energy = _frames_and_energy(wave, fo, opts.use_energy, opts.raw_energy, rng)
    keep = fo.padded_window_size // 2  # highest bin dropped
    spectrum = power_spectrum(padded, fo, keep_bins=keep, fft_mode=fft_mode)
    if not opts.use_power:
        spectrum = torch.sqrt(spectrum)
    mel = spectrum @ _const(_mel_banks64(opts.mel_opts, fo), spectrum)
    if opts.use_log_fbank:
        mel = torch.log(torch.clamp_min(mel, EPSILON))
    if opts.use_energy:
        e = _floored(log_energy, opts.energy_floor)[..., None]
        mel = torch.cat([mel, e] if opts.htk_compat else [e, mel], dim=-1)
    return mel


def compute_mfcc(wave: torch.Tensor, opts: MfccOptions = MfccOptions(), *, rng: Any = None,
                 fft_mode: str = "gemm") -> torch.Tensor:
    """MFCC. wave [..., num_samples] -> [..., num_frames, num_ceps]: the
    log-mel energies through the DCT, liftered; column 0 the log energy
    with ``use_energy``; with ``htk_compat`` C0 (or the energy) moved last,
    C0 scaled by sqrt(2) without ``use_energy``. ``rng`` and ``fft_mode``
    as in :func:`compute_fbank`.

    Parity: reference runtime/kaldifeat/csrc/feature-mfcc.cc:75-140.
    """
    fo = opts.frame_opts
    num_bins = opts.mel_opts.num_bins
    if opts.num_ceps > num_bins:
        raise ValueError("num_ceps cannot exceed num_mel_bins")
    padded, log_energy = _frames_and_energy(wave, fo, opts.use_energy, opts.raw_energy, rng)
    spectrum = power_spectrum(padded, fo, keep_bins=fo.padded_window_size // 2, fft_mode=fft_mode)
    mel = spectrum @ _const(_mel_banks64(opts.mel_opts, fo), spectrum)
    mel = torch.log(torch.clamp_min(mel, EPSILON))
    feats = mel @ _const(_dct64(opts.num_ceps, num_bins), mel)
    if opts.cepstral_lifter != 0.0:
        feats = feats * _const(_lifter64(opts.cepstral_lifter, opts.num_ceps), feats)
    if opts.use_energy:
        feats = _set_first(feats, _floored(log_energy, opts.energy_floor))
    if opts.htk_compat:
        energy = feats[..., :1]
        if not opts.use_energy:
            energy = energy * math.sqrt(2.0)
        feats = torch.cat([feats[..., 1:], energy], dim=-1)
    return feats


def compute_spectrogram(wave: torch.Tensor, opts: SpectrogramOptions = SpectrogramOptions(), *, rng: Any = None,
                        fft_mode: str = "gemm") -> torch.Tensor:
    """Log power spectrogram. wave [..., num_samples] -> [..., num_frames,
    padded_window_size // 2 + 1], column 0 the log energy.

    Parity: reference runtime/kaldifeat/csrc/feature-spectrogram.cc:22-66.
    """
    fo = opts.frame_opts
    padded, log_energy = _frames_and_energy(wave, fo, True, opts.raw_energy, rng)
    spectrum = power_spectrum(padded, fo, keep_bins=fo.padded_window_size // 2 + 1, fft_mode=fft_mode)
    spectrum = torch.log(torch.clamp_min(spectrum, EPSILON))
    return _set_first(spectrum, _floored(log_energy, opts.energy_floor))


@functools.lru_cache(maxsize=None)
def _mel_center_freqs64(mel_opts: MelOptions, frame_opts: FrameOptions, vtln_warp: float = 1.0) -> np.ndarray:
    num_bins = mel_opts.num_bins
    nyquist = 0.5 * frame_opts.samp_freq
    low_freq = mel_opts.low_freq
    high_freq = mel_opts.high_freq if mel_opts.high_freq > 0 else nyquist + mel_opts.high_freq
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    vtln_low = mel_opts.vtln_low
    vtln_high = mel_opts.vtln_high + nyquist if mel_opts.vtln_high < 0 else mel_opts.vtln_high
    centers = []
    for b in range(num_bins):
        center = mel_low + (b + 1) * mel_delta
        if vtln_warp != 1.0:
            center = _vtln_warp_mel(vtln_low, vtln_high, low_freq, high_freq, vtln_warp, center)
        centers.append(inverse_mel_scale(center))
    return np.asarray(centers, np.float64)


def mel_center_freqs(mel_opts: MelOptions, frame_opts: FrameOptions, vtln_warp: float = 1.0) -> np.ndarray:
    """Center frequency (Hz) of each mel bin, float32 (for the
    equal-loudness weights)."""
    return _mel_center_freqs64(mel_opts, frame_opts, vtln_warp).astype(np.float32)


def _equal_loudness(f0: np.ndarray) -> np.ndarray:
    fsq = f0 * f0
    fsub = fsq / (fsq + 1.6e5)
    return fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))


def equal_loudness_coeffs(mel_opts: MelOptions, frame_opts: FrameOptions, vtln_warp: float = 1.0) -> np.ndarray:
    """Equal-loudness weighting per mel bin, float32, from the float32
    center frequencies as JAX computes it.

    Parity: GetEqualLoudnessVector (reference
    runtime/kaldifeat/csrc/mel-computations.cc:214-227).
    """
    return _equal_loudness(mel_center_freqs(mel_opts, frame_opts, vtln_warp).astype(np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft64(n_bases: int, dimension: int) -> np.ndarray:
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2 * (dimension - 1))
    out = np.zeros((n_bases, dimension), np.float64)
    for i in range(n_bases):
        out[i, 0] = scale
        for j in range(1, dimension):
            out[i, j] = 2 * scale * math.cos(angle * i * j)
        out[i, dimension - 1] = scale * math.cos(angle * i * (dimension - 1))
    return out.T


def idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """IDFT basis matrix [dimension, n_bases] float32 (ready for ``mel @
    idft``). Parity: InitIdftBases (reference
    runtime/kaldifeat/csrc/feature-functions.cc:13-30)."""
    return _idft64(n_bases, dimension).astype(np.float32)


def _durbin(autocorr: torch.Tensor, order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin, vectorized over leading dims: autocorr [...,
    order+1] -> (lpc [..., order], residual energy E [...]). Parity: Durbin
    (reference mel-computations.cc:235-277); the recursion over ``order``
    unrolls, each step an update of whole tensors."""
    e = autocorr[..., 0]
    lp = [torch.zeros_like(e) for _ in range(order)]
    for i in range(order):
        ki = autocorr[..., i + 1]
        for j in range(i):
            ki = ki + lp[j] * autocorr[..., i - j]
        ki = ki / e
        e = e * torch.clamp_min(1.0 - ki * ki, 1.0e-5)
        new_lp = [lp[j] - ki * lp[i - j - 1] for j in range(i)]
        new_lp.append(-ki)
        lp[: i + 1] = new_lp
    return torch.stack(lp, dim=-1), e


def _lpc_to_cepstrum(lpc: torch.Tensor) -> torch.Tensor:
    """LPC -> cepstrum (parity: Lpc2CepstrumInternal mel-computations.cc:313)."""
    ceps = []
    for i in range(lpc.shape[-1]):
        s = torch.zeros_like(lpc[..., 0])
        for j in range(i):
            s = s + (i - j) * lpc[..., j] * ceps[i - j - 1]
        ceps.append(-lpc[..., i] - s / (i + 1))
    return torch.stack(ceps, dim=-1)


def compute_plp(wave: torch.Tensor, opts: PlpOptions = PlpOptions(), *, rng: Any = None, fft_mode: str = "gemm",
                vtln_warp: float = 1.0) -> torch.Tensor:
    """PLP. wave [..., num_samples] -> [..., num_frames, num_ceps]: mel
    energies -> equal loudness -> power compression -> IDFT to the
    autocorrelation -> Durbin LPC -> cepstrum -> lifter and scale; column
    0 the log energy with ``use_energy``. Arguments as in
    :func:`compute_fbank`.

    Parity: reference runtime/kaldifeat/csrc/feature-plp.cc:80-175.
    """
    fo = opts.frame_opts
    padded, log_energy = _frames_and_energy(wave, fo, opts.use_energy, opts.raw_energy, rng)
    spectrum = power_spectrum(padded, fo, keep_bins=fo.padded_window_size // 2, fft_mode=fft_mode)
    mel = spectrum @ _const(_mel_banks64(opts.mel_opts, fo, vtln_warp), spectrum)
    if mel.dtype == torch.float64:
        loudness = _equal_loudness(_mel_center_freqs64(opts.mel_opts, fo, vtln_warp))
    else:
        loudness = equal_loudness_coeffs(opts.mel_opts, fo, vtln_warp).astype(np.float64)
    mel = torch.clamp_min(mel * _const(loudness, mel), EPSILON) ** opts.compress_factor
    dup = torch.cat([mel[..., :1], mel, mel[..., -1:]], dim=-1)
    autocorr = dup @ _const(_idft64(opts.lpc_order + 1, opts.mel_opts.num_bins + 2), dup)
    lpc, resid = _durbin(autocorr, opts.lpc_order)
    c0 = torch.log(torch.clamp_min(resid, EPSILON))
    ceps = _lpc_to_cepstrum(lpc)
    feats = torch.cat([c0[..., None], ceps[..., : opts.num_ceps - 1]], dim=-1)
    if opts.cepstral_lifter != 0.0:
        feats = feats * _const(_lifter64(opts.cepstral_lifter, opts.num_ceps), feats)
    if opts.cepstral_scale != 1.0:
        feats = feats * opts.cepstral_scale
    if opts.use_energy:
        feats = _set_first(feats, _floored(log_energy, opts.energy_floor))
    if opts.htk_compat:
        feats = torch.cat([feats[..., 1:], feats[..., :1]], dim=-1)
    return feats


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
