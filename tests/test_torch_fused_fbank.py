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


# ---------------------------------------------------------------------------
# The tensor-core kernel's plan (csrc/fbank.cu, fbank_mma_kernel), walked in
# numpy: what the kernel does with addresses and fragments, on the CPU.

from asv_subtools_tpu_torch.features.fused_fbank import (  # noqa: E402
    _mma_matrix,
    interleaved_columns,
    mel_bands,
    mma_matrix_index,
)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _walk_tensor_core_plan(wave, opts):
    """Tiles of 64 frames (the last ragged); frames as strided views of the
    bf16 span, held in 16-byte pieces with a spare piece after every shift/8
    when that is even; the matrix in fragment order, in ring chunks of 32
    rows; re and im from neighbouring accumulator columns; mel over bands."""
    fo = opts.frame_opts
    shift, window = fo.window_shift, fo.window_size
    assert shift % 8 == 0
    n_b, n_s = wave.shape
    t = fo.num_frames(n_s)
    rows = -(-window // 32) * 32
    matrix = _mma_matrix(opts, torch.device("cpu")).float().numpy()
    p = shift // 8
    pad = 0 if p % 2 else 1
    n_span = 63 * shift + rows
    pieces = n_span // 8
    meta, weights = mel_bands(opts)
    lane = np.arange(32)
    g, tg = lane >> 2, lane & 3
    # B tile [16 k, 8 n] from a lane's two registers of two halves
    breg, half = np.meshgrid(np.arange(2), np.arange(2), indexing="ij")
    kk = 2 * tg[:, None, None] + half[None] + 8 * breg[None]
    nn = np.broadcast_to(g[:, None, None], kk.shape)
    out = np.zeros((n_b, t, opts.mel_opts.num_bins), np.float32)
    for b in range(n_b):
        for t0 in range(0, t, 64):
            start = t0 * shift
            avail = min(n_span, n_s - start)
            samples = np.zeros(n_span, np.float32)
            samples[:avail] = wave[b, start:start + avail]
            j = np.arange(pieces)
            span = np.full((pieces + (pieces // p + 1) * pad, 8), np.nan, np.float32)  # spare pieces are never read
            span[j + (j // p) * pad] = _bf16(samples).reshape(pieces, 8)
            acc = np.zeros((64, 512), np.float32)
            frames = np.arange(64)
            for c in range(rows // 32):
                chunk = matrix[c * 16384:(c + 1) * 16384].reshape(2, 8, 4, 32, 4, 2)
                for ks in range(2):
                    a = np.concatenate([span[frames * (p + pad) + kp + (kp // p) * pad]
                                        for kp in (4 * c + 2 * ks, 4 * c + 2 * ks + 1)], axis=1)  # [64, 16]
                    for w in range(8):
                        for jt in range(8):
                            tile = np.zeros((16, 8), np.float32)
                            tile[kk, nn] = chunk[ks, w, jt // 2, :, 2 * (jt % 2):2 * (jt % 2) + 2, :]
                            acc[:, 64 * w + 8 * jt:64 * w + 8 * jt + 8] += a @ tile
            assert np.isfinite(acc).all()
            re, im = acc[:, 0::2], acc[:, 1::2]  # a fragment holds columns 2 tg and 2 tg + 1
            power = re * re + im * im
            n_valid = min(64, t - t0)
            for m, (lo, cnt, off) in enumerate(meta):
                band = power[:n_valid, lo:lo + cnt] @ weights[off:off + cnt]
                out[b, t0:t0 + n_valid, m] = np.log(np.maximum(band, np.float32(tf.EPSILON)))
    return out


@pytest.mark.parametrize("num_samples,num_bins,length_ms,shift_ms", [
    (20480, 23, 25.0, 10.0),   # 126 frames: a full tile and a ragged one; shift/8 = 20, spare pieces
    (10640, 80, 25.5, 10.0),   # 65 frames; a 408-sample window in 416 rows
    (12001, 40, 30.0, 7.5),    # shift/8 = 15: no spare piece; a length that is not a multiple of 4
])
def test_tensor_core_plan_matches_plain(num_samples, num_bins, length_ms, shift_ms):
    wave = _wave(num_samples, (2, num_samples))
    opts = _opts(tf, num_bins, length_ms, shift_ms)
    ref, _ = fused_fbank_plain(torch.from_numpy(wave), opts, dft_dtype=torch.bfloat16, with_energy=False)
    got = _walk_tensor_core_plan(wave, opts)
    np.testing.assert_allclose(got, ref.numpy(), atol=2e-5, rtol=1e-5)


def test_interleaved_columns_pair_cos_and_sin_of_a_bin():
    perm = interleaved_columns(256)
    assert sorted(perm) == list(range(512))
    c = np.arange(256)
    np.testing.assert_array_equal(perm[2 * c], c)
    np.testing.assert_array_equal(perm[2 * c + 1], 256 + c)


@pytest.mark.parametrize("rows", [416, 480, 512])
def test_fragment_order_is_a_permutation_in_contiguous_chunks(rows):
    idx = mma_matrix_index(rows)
    np.testing.assert_array_equal(np.sort(idx), np.arange(rows * 512))
    k = (idx // 512).reshape(rows // 32, -1)  # a ring stage: 32 rows, 32 KB of bf16
    assert k.shape[1] * 2 == 32768
    assert (k.min(axis=1) == 32 * np.arange(rows // 32)).all() and (k.max(axis=1) == k.min(axis=1) + 31).all()
    with pytest.raises(ValueError):
        mma_matrix_index(408)


def test_tensor_core_matrix_holds_the_plain_versions_values():
    opts = _opts(tf, 23, 25.5, 10.0)  # 408-sample window: 416 rows, the last 8 zero
    flat = _mma_matrix(opts, torch.device("cpu"))
    assert flat.dtype == torch.bfloat16 and flat.shape == (416 * 512,)
    restored = np.zeros(416 * 512, np.float32)
    restored[mma_matrix_index(416)] = flat.float().numpy()
    restored = restored.reshape(416, 512)
    np.testing.assert_array_equal(restored[:408], _bf16(folded_dft(opts)[:408]))
    assert not restored[408:].any()
    assert _mma_matrix(tf.FbankOptions(), torch.device("cpu")).shape == (416 * 512,)  # 400 -> 416 rows
