"""Port fused fbank (kernel K1's plain version, which the wrapper runs on
CPU tensors) against the JAX Pallas `fused_fbank` in interpret mode.

Tolerances: log-mel atol 2e-5 / rtol 1e-5 and log-energy atol 1e-4
(tests/test_pallas_fbank.py:21,31). The bf16 DFT mode rounds the same
operands to bf16 on both sides and sums the exact products in f32, so the
two differ only in summation order: atol 1e-4. Against f32 it keeps
test_pallas_fbank.py:55-57's bounds (mean < 0.02, max < 0.5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asv_subtools_tpu import features as jf
from asv_subtools_tpu.features.pallas_fbank import fused_fbank as jax_fused_fbank
from asv_subtools_tpu_torch import features as tf
from asv_subtools_tpu_torch.features.fused_fbank import folded_dft, fused_fbank_plain

torch.set_num_threads(2)


def _wave(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 1000).astype(np.float32)


def _opts(pkg, num_bins=23, length_ms=25.0, shift_ms=10.0):
    return pkg.FbankOptions(
        frame_opts=pkg.FrameOptions(frame_length_ms=length_ms, frame_shift_ms=shift_ms),
        mel_opts=pkg.MelOptions(num_bins=num_bins))


def _jax(wave, opts, **kw):
    out, energy = jax_fused_fbank(jnp.asarray(wave), opts, interpret=True, **kw)
    return np.asarray(out), None if energy is None else np.asarray(energy)


def _port(wave, opts, **kw):
    out, energy = tf.fused_fbank(torch.from_numpy(wave), opts, **kw)
    return out.numpy(), None if energy is None else energy.numpy()


@pytest.mark.parametrize("num_bins", [23, 80])
@pytest.mark.parametrize("num_samples", [20480, 32000, 100000])
def test_matches_jax_kernel(num_bins, num_samples):
    wave = _wave(num_samples + num_bins, (2, num_samples))
    ref, ref_e = _jax(wave, _opts(jf, num_bins))
    got, got_e = _port(wave, _opts(tf, num_bins))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_e, ref_e, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("length_ms,shift_ms", [(30.0, 10.0), (32.0, 10.0), (30.0, 15.0), (25.5, 10.0)])
def test_window_geometry_matches_jax(length_ms, shift_ms):
    wave = _wave(6, (1, 32000))
    ref, ref_e = _jax(wave, _opts(jf, 23, length_ms, shift_ms))
    got, got_e = _port(wave, _opts(tf, 23, length_ms, shift_ms))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_e, ref_e, atol=1e-4, rtol=1e-5)


def test_energy_matches_raw_energy_fbank():
    wave = _wave(1, (1, 32000))
    ref = np.asarray(jf.compute_fbank(jnp.asarray(wave), jf.FbankOptions(use_energy=True),
                                      fft_mode="gemm"))
    _, energy = _port(wave, tf.FbankOptions())
    np.testing.assert_allclose(energy[0], ref[0, :, 0], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("num_bins", [23, 80])
def test_bf16_dft_matches_jax_bf16(num_bins):
    wave = _wave(3, (2, 32000))
    ref, _ = _jax(wave, _opts(jf, num_bins), dft_dtype=jnp.bfloat16, with_energy=False)
    got, none_e = _port(wave, _opts(tf, num_bins), dft_dtype=torch.bfloat16, with_energy=False)
    assert none_e is None
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_bf16_dft_tolerance_vs_f32():
    wave = _wave(3, (2, 32000))
    ref, _ = _port(wave, tf.FbankOptions())
    got, _ = _port(wave, tf.FbankOptions(), dft_dtype=torch.bfloat16)
    d = np.abs(got - ref)
    assert d.mean() < 0.02, d.mean()
    assert d.max() < 0.5, d.max()


def test_without_energy_is_identical():
    wave = _wave(4, (2, 32000))
    ref, energy = _port(wave, tf.FbankOptions())
    got, none_e = _port(wave, tf.FbankOptions(), with_energy=False)
    assert none_e is None and energy is not None
    np.testing.assert_array_equal(got, ref)


def test_plain_version_matches_functional_path():
    wave = _wave(8, (3, 24000))
    opts = _opts(tf, 80)
    got, _ = fused_fbank_plain(torch.from_numpy(wave), opts)
    ref = tf.compute_fbank(torch.from_numpy(wave), opts)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)


def test_folded_matrix_rows_past_window_are_zero():
    eff = folded_dft(tf.FbankOptions())
    assert eff.shape == (400, 512) and eff.dtype == np.float32
    eff30 = folded_dft(_opts(tf, 23, 30.0, 10.0))
    assert eff30.shape == (480, 512)
    eff408 = folded_dft(_opts(tf, 23, 25.5, 10.0))  # 408-sample window, padded to 416 rows
    assert eff408.shape == (416, 512)
    assert eff408[407].any() and not eff408[408:].any()


def test_rejects_dither_and_short_waves():
    with pytest.raises(ValueError):
        tf.fused_fbank(torch.zeros(1, 16000), tf.FbankOptions(frame_opts=tf.FrameOptions(dither=1.0)))
    with pytest.raises(ValueError):
        tf.fused_fbank(torch.zeros(1, 16000), tf.FbankOptions(frame_opts=tf.FrameOptions(snip_edges=False)))
    with pytest.raises(ValueError):
        tf.fused_fbank(torch.zeros(1, 399))
    with pytest.raises(ValueError):
        tf.fused_fbank(torch.zeros(16000))
