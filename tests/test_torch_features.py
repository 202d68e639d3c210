"""Port front end (asv_subtools_tpu_torch.features.functional) against the
JAX functional path and the float64 Kaldi golden.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: atol 2e-5 / rtol 1e-5 against the JAX gemm path (the JAX
fused-kernel tests' bound, tests/test_pallas_fbank.py:21); atol 2e-3
against the f64 golden (tests/test_features.py's bound: f32 vs f64 rfft).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_features as gold
from asv_subtools_tpu import features as jf
from asv_subtools_tpu_torch import features as tf

torch.set_num_threads(2)


def _wave(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 1000).astype(np.float32)


def _opts(pkg, num_bins=23, **kw):
    return pkg.FbankOptions(mel_opts=pkg.MelOptions(num_bins=num_bins), **kw)


@pytest.mark.parametrize("num_bins,shape", [
    (23, (2, 20480)), (23, (100000,)), (40, (32000,)), (40, (2, 32000)),
])
def test_compute_fbank_matches_jax(num_bins, shape):
    """23 and 40 bins, the JAX functional tests' settings. At 80 bins the
    lowest filters span one or two DFT bins whose power is tiny after
    preemphasis; there the f32 DC removal leaves both JAX and the port
    ~1e-4 from a float64 result, so 80 bins is held to the golden below
    and to the JAX kernel in test_torch_fused_fbank.py."""
    wave = _wave(num_bins, shape)
    ref = np.asarray(jf.compute_fbank(jnp.asarray(wave), _opts(jf, num_bins), fft_mode="gemm"))
    got = tf.compute_fbank(torch.from_numpy(wave), _opts(tf, num_bins)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(use_energy=True),
    dict(use_energy=True, htk_compat=True, energy_floor=1.0),
    dict(use_energy=True, raw_energy=False),
    dict(use_power=False, use_log_fbank=False),
])
def test_compute_fbank_options_match_jax(kw):
    wave = _wave(7, (2, 16000))
    ref = np.asarray(jf.compute_fbank(jnp.asarray(wave), _opts(jf, **kw), fft_mode="gemm"))
    got = tf.compute_fbank(torch.from_numpy(wave), _opts(tf, **kw)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("num_bins", [23, 40, 80])
def test_compute_fbank_matches_golden(num_bins):
    wave = _wave(3, 32000)
    got = tf.compute_fbank(torch.from_numpy(wave), _opts(tf, num_bins)).numpy()
    want = gold.golden_fbank(wave.astype(np.float64), num_bins=num_bins)
    assert got.shape == want.shape == (198, num_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_frame_signal_matches_golden():
    wave = _wave(4, 3 * 160 + 400 + 37)
    got = tf.frame_signal(torch.from_numpy(wave), tf.FrameOptions()).numpy()
    np.testing.assert_array_equal(got, gold.golden_frames(wave.astype(np.float64)))


@pytest.mark.parametrize("window_type", ["povey", "hamming", "hanning", "sine", "rectangular", "blackman"])
def test_host_constants_equal_jax(window_type):
    fo_j, fo_t = jf.FrameOptions(window_type=window_type), tf.FrameOptions(window_type=window_type)
    np.testing.assert_array_equal(tf.feature_window(fo_t), jf.feature_window(fo_j))
    np.testing.assert_array_equal(tf.mel_banks(tf.MelOptions(num_bins=80), fo_t),
                                  jf.mel_banks(jf.MelOptions(num_bins=80), fo_j))


@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cmvn_utterance_matches_jax(norm_vars, masked):
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(3, 50, 8)).astype(np.float32) * 3 + 1
    mask = np.arange(50)[None, :] < np.array([50, 31, 7])[:, None] if masked else None
    ref = np.asarray(jf.cmvn_utterance(
        jnp.asarray(feats), norm_vars=norm_vars, mask=None if mask is None else jnp.asarray(mask)))
    got = tf.cmvn_utterance(
        torch.from_numpy(feats), norm_vars=norm_vars,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_rejects_unported_framing():
    wave = torch.zeros(16000)
    with pytest.raises(ValueError):
        tf.compute_fbank(wave, tf.FbankOptions(frame_opts=tf.FrameOptions(dither=1.0)))
    with pytest.raises(ValueError):
        tf.compute_fbank(wave, tf.FbankOptions(frame_opts=tf.FrameOptions(snip_edges=False)))
