"""Kaldi-style pitch features: NCCF + lag interpolation + Viterbi + POV
(the port's own copy of asv_subtools_tpu/features/pitch.py, behaviour
unchanged: numpy in float64 on the host).

Parity target: Kaldi compute-kaldi-pitch / process-pitch-feats
(Ghahremani et al., "A pitch extraction algorithm tuned for ASR", ICASSP
2014), the algorithm of the reference's fbank_pitch/mfcc_pitch configs
(makeFeatures.sh -> steps/make_fbank_pitch.sh), with the option semantics
of the reference's runtime/kaldifeat/csrc/pitch-functions.h:27-125:

  1. lowpass + downsample the waveform to `resample_freq` (4 kHz) with a
     Kaldi LinearResample-style Hanning-windowed sinc at
     `lowpass_cutoff` (1 kHz), width `lowpass_filter_width`
  2. per frame, NCCF over INTEGER lags spanning [1/max_f0, 1/min_f0],
     with a ballast term that suppresses spurious unvoiced correlation
  3. windowed-sinc INTERPOLATION of the NCCF onto the exact geometric
     lag grid (spacing delta_pitch, sub-sample lag resolution: Kaldi's
     ArbitraryResample upsampling, width `upsample_filter_width`)
  4. Viterbi over lag states with an octave-jump penalty
     (penalty_factor * log(lag_i/lag_j)^2), vectorized over states; ties
     break to the first index (np.argmin)
  5. POV (probability-of-voicing) feature from the raw NCCF
  6. post-processing into the 3-dim Kaldi pitch feature
     (process-pitch-feats defaults):
       [pov_scale * pov_feature,
        pitch_scale * POV-weighted mean-subtracted log pitch
          (window = normalization_left/right_context; the online
           first-pass mode truncates the right context at the current
           frame, pitch-functions.h:60-86),
        delta_pitch_scale * delta log pitch]

Host-side numpy: pitch is data preparation (the Launcher's *_pitch feature
types), not the train step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PitchOptions:
    # extraction (PitchExtractionOptions defaults, pitch-functions.h:27-58)
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    soft_min_f0: float = 10.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    resample_freq: float = 4000.0
    delta_pitch: float = 0.005  # relative lag spacing
    nccf_ballast: float = 7000.0
    lowpass_filter_width: int = 1
    upsample_filter_width: int = 5
    # post-processing (Kaldi ProcessPitchOptions defaults)
    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    pov_offset: float = 0.0
    delta_pitch_scale: float = 10.0
    delta_window: int = 2
    normalization_left_context: int = 75
    normalization_right_context: int = 75
    # online first-pass simulation: normalize frame i with frames
    # <= i only (right context unavailable when queried immediately —
    # pitch-functions.h:78-86 simulate_first_pass_online)
    simulate_first_pass_online: bool = False
    # legacy centered-window override (pre-r4 configs); None = use the
    # left/right contexts above
    normalization_window: Optional[int] = None


def windowed_sinc_filter(t: np.ndarray, cutoff: float,
                         num_zeros: int) -> np.ndarray:
    """Kaldi resample.h FilterFunc: Hanning-windowed sinc, support
    |t| < num_zeros / (2 cutoff), DC gain 2*cutoff (divide by the source
    sample rate when using as interpolation weights)."""
    t = np.asarray(t, np.float64)
    half_support = num_zeros / (2.0 * cutoff)
    window = np.where(
        np.abs(t) < half_support,
        0.5 * (1.0 + np.cos(2.0 * np.pi * cutoff / num_zeros * t)),
        0.0,
    )
    safe = np.where(t == 0.0, 1.0, t)
    sinc = np.where(
        t == 0.0, 2.0 * cutoff, np.sin(2.0 * np.pi * cutoff * safe)
        / (np.pi * safe),
    )
    return window * sinc


def lowpass_resample(wave: np.ndarray, sr_in: float, sr_out: float,
                     cutoff: float, num_zeros: int) -> np.ndarray:
    """Kaldi LinearResample: windowed-sinc lowpass at `cutoff` evaluated
    at the output grid (one pass does both the anti-alias filter and the
    rate change)."""
    wave = np.asarray(wave, np.float64)
    n_in = len(wave)
    n_out = int(n_in * sr_out / sr_in)
    if n_out == 0:
        return np.zeros(0)
    t_out = np.arange(n_out) / sr_out  # seconds
    half_support = num_zeros / (2.0 * cutoff)  # seconds
    hw = int(math.ceil(half_support * sr_in)) + 1  # input samples
    center = np.round(t_out * sr_in).astype(int)  # nearest input index
    offs = np.arange(-hw, hw + 1)
    idx = center[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n_in)
    idx_c = np.clip(idx, 0, n_in - 1)
    t_rel = idx / sr_in - t_out[:, None]
    w = windowed_sinc_filter(t_rel, cutoff, num_zeros) / sr_in
    return np.sum(np.where(valid, wave[idx_c], 0.0) * w, axis=1)


def _candidate_lags(opts: PitchOptions) -> np.ndarray:
    """Geometric lag grid from 1/max_f0 to 1/min_f0 (Kaldi delta_pitch)."""
    min_lag = 1.0 / opts.max_f0
    max_lag = 1.0 / opts.min_f0
    lags = [min_lag]
    while lags[-1] < max_lag:
        lags.append(lags[-1] * (1.0 + opts.delta_pitch))
    return np.asarray(lags)


def _nccf_integer_lags(
    wave: np.ndarray, opts: PitchOptions, first_lag: int, last_lag: int
) -> Tuple[np.ndarray, np.ndarray]:
    """NCCF matrices [T, last-first+1] at every INTEGER lag, with and
    without ballast.

    nccf(t, l) = <x_t, x_{t+l}> / sqrt((e_t + B)(e_{t+l} + B))
    where x_t is the window starting at frame t's sample offset.
    """
    sr = opts.resample_freq
    shift = int(sr * opts.frame_shift_ms / 1000.0)
    window = int(sr * opts.frame_length_ms / 1000.0)
    n = len(wave)
    n_lags = last_lag - first_lag + 1
    t_frames = max(0, 1 + (n - (window + last_lag)) // shift)
    if t_frames == 0:
        return np.zeros((0, n_lags)), np.zeros((0, n_lags))

    # ballast in energy^2 units (inside the sqrt of the energy product):
    # denom = sqrt(e0*e1 + nccf_ballast * global_mean_sq^2). For voiced
    # frames e0*e1 ~ (w*ms)^2 dominates; for quiet frames the ballast
    # squashes the correlation toward zero.
    mean_sq = float(np.mean(wave**2)) + 1e-10
    ballast = opts.nccf_ballast * mean_sq * mean_sq

    starts = np.arange(t_frames) * shift
    idx = starts[:, None] + np.arange(window)[None, :]
    frames0 = wave[idx]  # [T, W]
    e0 = np.sum(frames0**2, axis=1)  # [T]

    nccf_b = np.zeros((t_frames, n_lags))
    nccf_nb = np.zeros((t_frames, n_lags))
    for li in range(n_lags):
        lag = first_lag + li
        frames_l = wave[idx + lag]
        cross = np.sum(frames0 * frames_l, axis=1)
        e1 = np.sum(frames_l**2, axis=1)
        nccf_b[:, li] = cross / (np.sqrt(e0 * e1 + ballast) + 1e-10)
        nccf_nb[:, li] = cross / (np.sqrt(e0 * e1) + 1e-10)
    return nccf_b, nccf_nb


def resample_nccf(nccf: np.ndarray, first_lag: int, lags_sec: np.ndarray,
                  opts: PitchOptions) -> np.ndarray:
    """Interpolate NCCF rows (sampled at integer lags, spacing
    1/resample_freq) onto the exact geometric lag grid with the
    upsampling windowed sinc (Kaldi ArbitraryResample, cutoff =
    resample_freq/2, width upsample_filter_width) — sub-sample lag
    resolution instead of rounding lags to whole samples."""
    sr = opts.resample_freq
    cutoff = 0.5 * sr
    num_zeros = opts.upsample_filter_width
    pos = lags_sec * sr - first_lag  # fractional index into nccf columns
    n_in = nccf.shape[1]
    hw = int(math.ceil(num_zeros / (2.0 * cutoff) * sr)) + 1
    center = np.round(pos).astype(int)
    offs = np.arange(-hw, hw + 1)
    idx = center[:, None] + offs[None, :]  # [L_out, K]
    valid = (idx >= 0) & (idx < n_in)
    idx_c = np.clip(idx, 0, n_in - 1)
    t_rel = (idx - pos[:, None]) / sr  # seconds
    w = windowed_sinc_filter(t_rel, cutoff, num_zeros) / sr  # [L_out, K]
    w = np.where(valid, w, 0.0)
    # out[t, l] = sum_k nccf[t, idx[l, k]] * w[l, k]
    return np.einsum("tlk,lk->tl", nccf[:, idx_c], w)


def _viterbi_lags(
    nccf: np.ndarray, lags: np.ndarray, opts: PitchOptions
) -> np.ndarray:
    """Best lag index per frame via Viterbi with octave-jump penalty."""
    t, l = nccf.shape
    if t == 0:
        return np.zeros(0, int)
    log_lag = np.log(lags)
    # transition cost [L, L]: the paper's octave-jump penalty
    # penalty_factor * log(lag_i/lag_j)^2 (Ghahremani 2014, eq. 3)
    diff = log_lag[:, None] - log_lag[None, :]
    trans = opts.penalty_factor * diff**2
    # local cost with the soft-min-f0 lag penalty (paper eq. 2:
    # 1 - nccf * (1 - soft_min_f0 * lag)) — breaks subharmonic ties toward
    # the shorter lag, since integer multiples of the period correlate too
    cost = 1.0 - nccf * (1.0 - opts.soft_min_f0 * lags[None, :])
    acc = cost[0].copy()
    back = np.zeros((t, l), np.int32)
    for i in range(1, t):
        total = acc[None, :] + trans  # [to, from]
        back[i] = np.argmin(total, axis=1)
        acc = total[np.arange(l), back[i]] + cost[i]
    path = np.zeros(t, np.int32)
    path[-1] = int(np.argmin(acc))
    for i in range(t - 2, -1, -1):
        path[i] = back[i + 1][path[i + 1]]
    return path


def _nccf_to_pov_feature(nccf: np.ndarray) -> np.ndarray:
    """Kaldi NccfToPovFeature: f = 2*((1.0001 - nccf)^0.15 - 1)."""
    return 2.0 * ((1.0001 - nccf) ** 0.15 - 1.0)


def nccf_to_pov(nccf: np.ndarray) -> np.ndarray:
    """Kaldi NccfToPov: probability of voicing from NCCF via the published
    polynomial fit on |nccf|."""
    c = np.abs(np.clip(nccf, -1.0, 1.0))
    # Kaldi pitch-functions.cc NccfToPov polynomial
    ndash = -5.2 + 5.4 * np.exp(7.5 * (c - 1.0)) + 4.8 * c - 2.0 * np.exp(
        -10.0 * c
    ) + 4.2 * np.exp(20.0 * (c - 1.0))
    return 1.0 / (1.0 + np.exp(-ndash))


def compute_kaldi_pitch(
    wave: np.ndarray, opts: PitchOptions = PitchOptions()
) -> np.ndarray:
    """wave [S] at opts.samp_freq -> [T, 2] (nccf_pov_raw, pitch_hz).

    T matches the standard Kaldi frame count for the SAME shift at the
    original rate (frames are trimmed/padded by edge copy to align with
    fbank frames).
    """
    sr = opts.resample_freq
    down = lowpass_resample(
        np.asarray(wave, np.float64), opts.samp_freq, sr,
        opts.lowpass_cutoff, opts.lowpass_filter_width,
    )

    lags_sec = _candidate_lags(opts)
    first_lag = int(math.floor(lags_sec[0] * sr))
    last_lag = int(math.ceil(lags_sec[-1] * sr))

    nccf_b_int, nccf_nb_int = _nccf_integer_lags(
        down, opts, first_lag, last_lag
    )
    if nccf_b_int.shape[0] == 0:
        return np.zeros((0, 2), np.float32)
    # sub-sample lag resolution: interpolate both matrices onto the exact
    # geometric grid before tracking
    nccf_b = resample_nccf(nccf_b_int, first_lag, lags_sec, opts)
    nccf_nb = resample_nccf(nccf_nb_int, first_lag, lags_sec, opts)
    path = _viterbi_lags(nccf_b, lags_sec, opts)
    t = len(path)
    pitch = 1.0 / lags_sec[path]
    best_nccf = nccf_nb[np.arange(t), path]

    # align to the fbank frame count at the original rate
    shift = int(opts.samp_freq * opts.frame_shift_ms / 1000.0)
    window = int(opts.samp_freq * opts.frame_length_ms / 1000.0)
    t_target = max(0, 1 + (len(wave) - window) // shift)
    out = np.zeros((t_target, 2), np.float32)
    n = min(t, t_target)
    out[:n, 0] = best_nccf[:n]
    out[:n, 1] = pitch[:n]
    if t_target > n and n > 0:  # pad by edge copy
        out[n:, 0] = best_nccf[n - 1]
        out[n:, 1] = pitch[n - 1]
    return out


def process_pitch(
    raw: np.ndarray, opts: PitchOptions = PitchOptions()
) -> np.ndarray:
    """Raw (nccf, pitch) -> 3-dim Kaldi pitch feature
    [pov_scale*pov_feature + pov_offset,
     pitch_scale*normalized_log_pitch, delta_pitch_scale*delta]
    (process-pitch-feats defaults: add-pov-feature,
    add-normalized-log-pitch, add-delta-pitch; pitch_scale=2, pov_scale=2,
    delta_pitch_scale=10)."""
    if raw.shape[0] == 0:
        return np.zeros((0, 3), np.float32)
    # the sinc lag interpolation can overshoot |nccf| slightly past 1
    # (ringing); clip before the (1.0001 - nccf)^0.15 pov feature goes NaN
    nccf = np.clip(raw[:, 0], -1.0, 1.0)
    pitch = np.maximum(raw[:, 1], 1.0)
    pov_feat = _nccf_to_pov_feature(nccf) * opts.pov_scale + opts.pov_offset
    pov = nccf_to_pov(nccf)
    log_pitch = np.log(pitch)

    # POV-weighted moving-average subtraction. Offline: the full
    # [i-left, i+right] window; online first-pass: only frames <= i are
    # available when frame i is queried, so the right context truncates
    # at the current frame (pitch-functions.h:78-86).
    t = len(pitch)
    if opts.normalization_window is not None:  # legacy centered override
        left = right = opts.normalization_window // 2
    else:
        left = opts.normalization_left_context
        right = opts.normalization_right_context
    if opts.simulate_first_pass_online:
        right = 0
    norm_log = np.zeros(t)
    csum_w = np.concatenate([[0.0], np.cumsum(pov)])
    csum_wl = np.concatenate([[0.0], np.cumsum(pov * log_pitch)])
    for i in range(t):
        a, b = max(0, i - left), min(t, i + right + 1)
        w = csum_w[b] - csum_w[a]
        wl = csum_wl[b] - csum_wl[a]
        mean = wl / max(w, 1e-10)
        norm_log[i] = log_pitch[i] - mean

    # delta pitch over a small window
    dw = opts.delta_window
    delta = np.zeros(t)
    denom = sum(j * j for j in range(1, dw + 1)) * 2.0
    for j in range(1, dw + 1):
        upper = np.concatenate([log_pitch[j:], np.repeat(log_pitch[-1], j)])
        lower = np.concatenate([np.repeat(log_pitch[0], j), log_pitch[:-j]])
        delta += j * (upper - lower)
    delta /= denom

    return np.stack(
        [pov_feat, norm_log * opts.pitch_scale,
         delta * opts.delta_pitch_scale],
        axis=1,
    ).astype(np.float32)


def compute_and_process_pitch(
    wave: np.ndarray, opts: PitchOptions = PitchOptions()
) -> np.ndarray:
    """wave -> 3-dim pitch features aligned with fbank frames (the
    `fbank_pitch` pipeline appends these to the fbank matrix)."""
    return process_pitch(compute_kaldi_pitch(wave, opts), opts)
