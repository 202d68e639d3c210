"""The port's Kaldi pitch (asv_subtools_tpu_torch.features.pitch) against
JAX's features/pitch.py, stage by stage, in float64 at JAX's golden gates
(atol 1e-6, rtol 1e-5; tests/test_pitch.py:49-160), and against the loop
transcriptions of tests/golden_pitch.py. Inputs are made with numpy from a
seed: voiced tone segments, silence and noise, and tones whose F0 moves.
The Viterbi path and its ties (to the first index, as np.argmin breaks
them) are held exactly.
"""

import dataclasses
import math

import numpy as np
import pytest

import golden_pitch as gold
from asv_subtools_tpu.features import pitch as jp
from asv_subtools_tpu_torch.features import pitch as tp

TOL = dict(rtol=1e-5, atol=1e-6)
SR = 16000


def _speechy(seconds=0.6, sr=4000, seed=0):
    """Voiced tone segments, silence and noise at the NCCF working rate."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds / 3)) / sr
    voiced = sum(np.sin(2 * np.pi * 130.0 * (h + 1) * t) / (h + 1) for h in range(3))
    return np.concatenate([voiced * 0.8, np.zeros_like(t), rng.normal(size=len(t)) * 0.3])


def _gliding_tone(seconds=1.2, seed=0, f0=(110.0, 220.0)):
    """A 16 kHz tone whose F0 glides, with harmonics and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    f = np.linspace(*f0, t.size)
    phase = 2 * np.pi * np.cumsum(f) / SR
    wave = sum(np.sin((h + 1) * phase) / (h + 1) for h in range(4)) * 4000
    return wave + rng.normal(size=t.size) * 100


def _lags(opts):
    lags = tp._candidate_lags(opts)
    first = int(math.floor(lags[0] * opts.resample_freq))
    last = int(math.ceil(lags[-1] * opts.resample_freq))
    return lags, first, last


OPTIONS = [
    {},
    dict(min_f0=60.0, max_f0=350.0, delta_pitch=0.01),
    dict(samp_freq=8000.0, penalty_factor=0.2, nccf_ballast=1000.0),
    dict(upsample_filter_width=3, lowpass_filter_width=2, soft_min_f0=20.0),
]


def test_options_equal_jax():
    assert dataclasses.asdict(tp.PitchOptions()) == dataclasses.asdict(jp.PitchOptions())


@pytest.mark.parametrize("kw", OPTIONS)
def test_candidate_lags_and_resample_match_jax(kw):
    o = tp.PitchOptions(**kw)
    np.testing.assert_array_equal(tp._candidate_lags(o), jp._candidate_lags(jp.PitchOptions(**kw)))
    wave = _gliding_tone(0.5, seed=1)
    ours = tp.lowpass_resample(wave, o.samp_freq, o.resample_freq, o.lowpass_cutoff, o.lowpass_filter_width)
    ref = jp.lowpass_resample(wave, o.samp_freq, o.resample_freq, o.lowpass_cutoff, o.lowpass_filter_width)
    np.testing.assert_allclose(ours, ref, **TOL)
    want = gold.golden_lowpass_resample(wave, o.samp_freq, o.resample_freq, o.lowpass_cutoff, o.lowpass_filter_width)
    np.testing.assert_allclose(ours, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tp.windowed_sinc_filter(np.linspace(-3e-3, 3e-3, 41), 1000.0, 2),
                               jp.windowed_sinc_filter(np.linspace(-3e-3, 3e-3, 41), 1000.0, 2), **TOL)


@pytest.mark.parametrize("kw", OPTIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_nccf_resample_and_viterbi_match_jax(kw, seed):
    o, oj = tp.PitchOptions(**kw), jp.PitchOptions(**kw)
    wave = _speechy(seed=seed)
    lags, first, last = _lags(o)
    nb, nn = tp._nccf_integer_lags(wave, o, first, last)
    jb, jn = jp._nccf_integer_lags(wave, oj, first, last)
    np.testing.assert_allclose(nb, jb, **TOL)
    np.testing.assert_allclose(nn, jn, **TOL)
    rb = tp.resample_nccf(nb, first, lags, o)
    np.testing.assert_allclose(rb, jp.resample_nccf(jb, first, lags, oj), **TOL)
    for t in (0, len(rb) // 2):
        np.testing.assert_allclose(rb[t], gold.golden_resample_nccf(nb[t], first, lags, o.resample_freq,
                                                                    o.upsample_filter_width), rtol=1e-9, atol=1e-12)
    path = tp._viterbi_lags(rb, lags, o)
    np.testing.assert_array_equal(path, jp._viterbi_lags(rb, lags, oj))
    # the golden's scalar loops cost T x L x L: a prefix of the frames
    np.testing.assert_array_equal(tp._viterbi_lags(rb[:10], lags, o),
                                  gold.golden_viterbi(rb[:10], lags, o.penalty_factor, o.soft_min_f0))


def test_viterbi_ties_break_to_the_first_index():
    """Every state costs the same at every frame: each argmin is the first
    index, on both sides."""
    o = tp.PitchOptions(penalty_factor=0.0, soft_min_f0=0.0)
    lags = tp._candidate_lags(o)
    nccf = np.full((6, len(lags)), 0.3)
    path = tp._viterbi_lags(nccf, lags, o)
    np.testing.assert_array_equal(path, np.zeros(6, np.int32))
    np.testing.assert_array_equal(path, jp._viterbi_lags(nccf, lags, jp.PitchOptions(penalty_factor=0.0,
                                                                                      soft_min_f0=0.0)))
    assert len(tp._viterbi_lags(nccf[:0], lags, o)) == 0


def test_pov_functions_match_jax():
    nccf = np.linspace(-1.1, 1.0, 97)
    np.testing.assert_allclose(tp._nccf_to_pov_feature(nccf), jp._nccf_to_pov_feature(nccf), **TOL)
    np.testing.assert_allclose(tp.nccf_to_pov(nccf), jp.nccf_to_pov(nccf), **TOL)
    np.testing.assert_allclose(tp.nccf_to_pov(nccf), gold.golden_pov(nccf), rtol=1e-12)


@pytest.mark.parametrize("kw", [{}, dict(simulate_first_pass_online=True), dict(normalization_window=50),
                                dict(normalization_left_context=20, normalization_right_context=5,
                                     delta_window=3, pov_offset=0.5)])
def test_process_pitch_matches_jax(kw):
    """The offline window, the online first pass (no right context) and the
    legacy centred window."""
    rng = np.random.default_rng(2)
    t = 200
    raw = np.stack([np.clip(rng.normal(0.5, 0.3, t), -1.0, 1.0), np.exp(rng.normal(np.log(150.0), 0.2, t))], axis=1)
    ours = tp.process_pitch(raw, tp.PitchOptions(**kw))
    np.testing.assert_allclose(ours, jp.process_pitch(raw, jp.PitchOptions(**kw)), **TOL)
    if not kw or "simulate_first_pass_online" in kw:
        o = tp.PitchOptions(**kw)
        want = gold.golden_process(raw[:, 0], raw[:, 1], o.pov_scale, o.pitch_scale, o.delta_pitch_scale,
                                   o.normalization_left_context, o.normalization_right_context, o.delta_window,
                                   online=o.simulate_first_pass_online)
        np.testing.assert_allclose(ours, want, **TOL)
    assert tp.process_pitch(raw[:0]).shape == (0, 3)


@pytest.mark.parametrize("kw", OPTIONS[:3])
@pytest.mark.parametrize("seconds", [0.02, 1.2])
def test_compute_and_process_pitch_match_jax(kw, seconds):
    """The whole tracker on a 16 kHz (or 8 kHz) tone, frames aligned with
    the fbank's, and on a wave too short for one NCCF frame (no frames on
    either side, though the fbank may have some)."""
    wave = _gliding_tone(seconds, seed=3)
    o, oj = tp.PitchOptions(**kw), jp.PitchOptions(**kw)
    raw = tp.compute_kaldi_pitch(wave, o)
    np.testing.assert_allclose(raw, jp.compute_kaldi_pitch(wave, oj), **TOL)
    feats = tp.compute_and_process_pitch(wave, o)
    np.testing.assert_allclose(feats, jp.compute_and_process_pitch(wave, oj), **TOL)
    assert feats.dtype == np.float32
    if seconds > 1:
        shift, window = int(o.samp_freq / 100), int(o.samp_freq * 0.025)
        assert feats.shape == (1 + (len(wave) - window) // shift, 3)
        assert np.isfinite(feats).all()
        voiced = raw[20:-20, 1]
        assert 80.0 < np.median(voiced) < 300.0  # the glide's 110-220 Hz
