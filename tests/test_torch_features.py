"""Port front end (asv_subtools_tpu_torch.features.functional) against the
JAX functional path and the float64 Kaldi golden.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: atol 2e-5 / rtol 1e-5 against the JAX gemm path (the JAX
fused-kernel tests' bound, tests/test_pallas_fbank.py:21); atol 2e-3
against the f64 golden (tests/test_features.py's bound: f32 vs f64 rfft).

The Kaldi-style host front end: dither (numpy Generators of one seed on
both sides, fbank within 2e-5) and snip_edges=False framing (exactly
JAX's frames) in the plain path, while the fused kernel and its plain
version still reject both; energy VAD plain and masked and voiced-frame
selection exactly equal to JAX's; sliding CMVN within 1e-5 (JAX's
tests/test_features.py:145-153 edge windows held too).
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


@pytest.mark.parametrize("length", [16000, 16037, 399, 240])
def test_frame_signal_without_snip_edges_equals_jax(length):
    """snip_edges=False: frames centred on multiples of the shift, the wave
    reflected at both ends; exactly JAX's frames (and the golden's), on
    waves of a frame or less too."""
    wave = _wave(7, (length,))
    opts = dict(snip_edges=False)
    ref = np.asarray(jf.frame_signal(wave, jf.FrameOptions(**opts)))
    got = tf.frame_signal(torch.from_numpy(wave), tf.FrameOptions(**opts)).numpy()
    assert got.shape == ref.shape == (tf.FrameOptions(**opts).num_frames(length), 400)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, gold.golden_frames(wave.astype(np.float64), snip_edges=False))
    batched = tf.frame_signal(torch.from_numpy(np.stack([wave, wave[::-1].copy()])), tf.FrameOptions(**opts))
    np.testing.assert_array_equal(batched[0].numpy(), got)


@pytest.mark.parametrize("snip_edges", [True, False])
@pytest.mark.parametrize("num_bins,use_energy", [(23, False), (80, True)])
def test_dithered_fbank_matches_jax(num_bins, use_energy, snip_edges):
    """dither 1.0 (Kaldi's default) drawn from numpy Generators of one seed
    on both sides (JAX's host path), the rfft mode of the host pipeline;
    the energy column is the log of the dithered frames' energy. Within
    2e-5 of JAX; without a generator neither side dithers."""
    wave = _wave(11, (24037,))
    kw = dict(frame_opts=dict(dither=1.0, snip_edges=snip_edges), use_energy=use_energy)
    make = lambda pkg: pkg.FbankOptions(frame_opts=pkg.FrameOptions(**kw["frame_opts"]),
                                        mel_opts=pkg.MelOptions(num_bins=num_bins), use_energy=use_energy)
    ref = np.asarray(jf.compute_fbank(wave, make(jf), rng=np.random.default_rng(3)))
    got = tf.compute_fbank(torch.from_numpy(wave), make(tf), rng=np.random.default_rng(3), fft_mode="rfft").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    plain = tf.compute_fbank(torch.from_numpy(wave), make(tf), fft_mode="rfft").numpy()
    np.testing.assert_allclose(plain, np.asarray(jf.compute_fbank(wave, make(jf))), atol=2e-5, rtol=1e-5)
    assert np.abs(plain - got).max() > 1e-3  # the dither moved the quiet bins


def test_dither_from_a_torch_generator():
    """On a tensor's device the dither comes from a torch.Generator: seeded
    runs repeat, and the noise has the std the options give."""
    frames = torch.zeros(200, 400)
    opts = tf.FrameOptions(dither=2.0, remove_dc_offset=False, preemph_coeff=0.0, window_type="rectangular")
    from asv_subtools_tpu_torch.features.functional import _process_window

    a, _ = _process_window(frames, opts, rng=torch.Generator().manual_seed(1))
    b, _ = _process_window(frames, opts, rng=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert abs(float(a[:, :400].std()) - 2.0) < 0.02
    with pytest.raises(TypeError):
        _process_window(frames, opts, rng=1234)


def test_fused_fbank_still_rejects_dither_and_snip_edges_false():
    """The kernel's wrapper and its plain version take neither option (JAX's
    fused_fbank raises on both, pallas_fbank.py:254-255)."""
    wave = torch.zeros(1, 16000)
    for frame_opts in (tf.FrameOptions(dither=1.0), tf.FrameOptions(snip_edges=False)):
        opts = tf.FbankOptions(frame_opts=frame_opts)
        for fn in (tf.fused_fbank, tf.fused_fbank_plain):
            with pytest.raises(ValueError, match="dither=0 and snip_edges=True"):
                fn(wave, opts)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ctx,mean_scale,threshold", [(0, 0.5, 5.5), (2, 0.5, 5.5), (3, 0.0, 10.0)])
def test_compute_vad_energy_equals_jax(ctx, mean_scale, threshold, masked):
    log_e = (np.random.default_rng(ctx).standard_normal((3, 200)) * 3 + 10).astype(np.float32)
    mask = np.arange(200)[None] < np.array([200, 131, 40])[:, None] if masked else None
    make = lambda pkg: pkg.VadOptions(frames_context=ctx, energy_mean_scale=mean_scale, energy_threshold=threshold)
    ref = np.asarray(jf.compute_vad_energy(jnp.asarray(log_e), make(jf), None if mask is None else jnp.asarray(mask)))
    got = tf.compute_vad_energy(torch.from_numpy(log_e), make(tf), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < ref.size
    if masked:
        assert not got.numpy()[~mask].any()
    one = tf.compute_vad_energy(torch.from_numpy(log_e[1]), make(tf))
    np.testing.assert_array_equal(one.numpy(), np.asarray(jf.compute_vad_energy(jnp.asarray(log_e[1]), make(jf))))


def test_compute_vad_energy_matches_golden():
    log_e = np.random.default_rng(0).standard_normal(200) * 3 + 10
    for ctx in (0, 2):
        got = tf.compute_vad_energy(torch.from_numpy(log_e.astype(np.float32)), tf.VadOptions(frames_context=ctx))
        np.testing.assert_array_equal(got.numpy(), gold.golden_vad(log_e, context=ctx))


@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("t,window", [(400, 300), (1000, 301), (250, 300)])
def test_cmvn_sliding_matches_jax(t, window, norm_vars):
    """Windows shifted inside the utterance at both edges (frame 0: frames
    [0, window); the last frame: the last window), an odd window, and an
    utterance shorter than its window (utterance CMVN); within 1e-5."""
    x = (np.random.default_rng(t).standard_normal((2, t, 6)) * 2 + 3).astype(np.float32)
    got = tf.cmvn_sliding(torch.from_numpy(x), window=window, norm_vars=norm_vars).numpy()
    for b in range(2):
        ref = np.asarray(jf.cmvn_sliding(jnp.asarray(x[b]), window=window, norm_vars=norm_vars))
        np.testing.assert_allclose(got[b], ref, atol=1e-5, rtol=1e-5)
    if t > window and not norm_vars:
        np.testing.assert_allclose(got[0, 0], x[0, 0] - x[0, :window].mean(0), atol=1e-5)
        np.testing.assert_allclose(got[0, -1], x[0, -1] - x[0, -window:].mean(0), atol=1e-5)
        mid = t // 2
        lo = mid - window // 2
        np.testing.assert_allclose(got[0, mid], x[0, mid] - x[0, lo:lo + window].mean(0), atol=1e-5)


def test_select_voiced_frames_equals_jax():
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((3, 40, 5)).astype(np.float32)
    voiced = (rng.random((3, 40)) > 0.4).astype(np.float32)
    voiced[2] = 0.0  # nothing voiced
    got, mask = tf.select_voiced_frames(torch.from_numpy(feats), torch.from_numpy(voiced))
    ref, ref_mask = jf.select_voiced_frames(jnp.asarray(feats), jnp.asarray(voiced))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    for b in range(2):
        n = int(voiced[b].sum())
        np.testing.assert_array_equal(got[b, :n].numpy(), feats[b][voiced[b] > 0.5])
    assert not mask[2].any()
