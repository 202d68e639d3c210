"""The port's MFCC, PLP, spectrogram, VTLN warp, feature options and Kaldi
conf files (asv_subtools_tpu_torch.features) against the JAX package and
the float64 Kaldi golden (tests/golden_features.py).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances:
* MFCC and the spectrogram against JAX's numpy host path and its jnp
  path: JAX's own 2e-4 (tests/test_features.py:303-325). Measured (23 and
  80 bins, the options below): MFCC 4.9e-5 from the numpy path, 2.3e-4
  from the jnp path at 80 bins (within rtol); spectrogram 3.7e-5 and
  1.2e-4.
* Against the f64 golden: f32 at JAX's 2e-3 (tests/test_features.py:89-96
  and :174-184); the port run in float64 at 1e-8 (measured: MFCC 8e-14,
  PLP 1.8e-14). The golden frames a float32 wave in float32 (its DC
  removal then moves PLP by 3.4e-7 from the float64 result): it is fed
  the float64 wave.
* PLP against JAX's jnp path in f32: 2e-4, the MFCC bound (measured
  1.9e-5 at 80 bins, 8.7e-6 at 23). Levinson-Durbin against JAX's on the
  same f32 autocorrelation: 1e-5.
* The host constants (window, mel banks with and without the VTLN warp,
  DCT, lifter, IDFT bases, equal loudness) are JAX's exactly: both round
  the same float64 values to float32.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_features as gold
from asv_subtools_tpu import features as jf
from asv_subtools_tpu.features import functional as jfun
from asv_subtools_tpu.data import processor as jproc
from asv_subtools_tpu_torch import features as tf
from asv_subtools_tpu_torch.data import processor as tproc
from asv_subtools_tpu_torch.features import functional as tfun

torch.set_num_threads(2)

JAX_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_features.py:303-325
GOLDEN_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_features.py:89-96, 174-184
F64_TOL = dict(rtol=1e-8, atol=1e-8)

MFCC_OPTIONS = [
    {},
    dict(htk_compat=True),
    dict(use_energy=False),
    dict(use_energy=False, htk_compat=True),
    dict(energy_floor=1.0),
    dict(raw_energy=False),
]


def _wave(seed, shape, scale=4000.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mel(pkg, num_bins):
    return pkg.MelOptions(num_bins=num_bins)


def _asdict(opts):
    return dataclasses.asdict(opts)


# -- options and conf files --------------------------------------------------


@pytest.mark.parametrize("name", ["MfccOptions", "PlpOptions", "SpectrogramOptions"])
def test_option_defaults_and_dims_equal_jax(name):
    ours, ref = getattr(tf, name)(), getattr(jf, name)()
    assert _asdict(ours) == _asdict(ref) and ours.dim == ref.dim
    if name != "SpectrogramOptions":
        ours = getattr(tf, name)(mel_opts=tf.MelOptions(num_bins=40), num_ceps=20)
        ref = getattr(jf, name)(mel_opts=jf.MelOptions(num_bins=40), num_ceps=20)
        assert ours.dim == ref.dim == 20


# The lines of the reference's conf files, rebuilt from what JAX's tests
# assert of them (tests/test_features.py:220-266), plus a PLP, a
# spectrogram and a pitch conf.
CONFS = {
    "sre-fbank-81.conf": ("fbank", "--sample-frequency=16000\n--frame-length=25 # the default\n--low-freq=40\n"
                                   "--high-freq=-200\n--num-mel-bins=80\n--use-energy=true\n--dither=0\n"),
    "sre-mfcc-23.conf": ("mfcc", "# MFCC for the SRE x-vector recipes\n--sample-frequency=16000\n"
                                 "--frame-length=25\n\n--low-freq=20\n--high-freq=-200\n--num-mel-bins=23\n"
                                 "--num-ceps=23\n--snip-edges=false\n# end\n"),
    "vad-5.5.conf": ("vad", "--vad-energy-threshold=5.5\n--vad-energy-mean-scale=0.5\n--sample-frequency=16000\n"),
    "plp.conf": ("plp", "--sample-frequency=8000\n--lpc-order=10\n--compress-factor=0.5\n--window-type=hamming\n"),
    "spectrogram.conf": ("spectrogram", "--frame-shift=12.5\n--raw-energy=false\n--energy-floor=1.0\n"),
    "pitch.conf": ("pitch", "--sample-frequency=8000\n--min-f0=60\n--max-f0=350\n--soft-min-f0=20.0\n"),
}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_kaldi_conf_parses_as_jax(tmp_path, name):
    feat_type, text = CONFS[name]
    path = tmp_path / name
    path.write_text(text)
    assert tf.parse_kaldi_conf(str(path)) == jf.parse_kaldi_conf(str(path))
    ours = tf.options_from_kaldi_conf(str(path), feat_type)
    ref = jf.options_from_kaldi_conf(str(path), feat_type)
    assert type(ours).__name__ == type(ref).__name__ and _asdict(ours) == _asdict(ref)
    if name == "sre-fbank-81.conf":
        assert (ours.frame_opts.samp_freq, ours.use_energy, ours.mel_opts.num_bins, ours.mel_opts.low_freq,
                ours.mel_opts.high_freq, ours.frame_opts.dither, ours.dim) == (16000, True, 80, 40, -200, 0, 81)
    if name == "sre-mfcc-23.conf":
        assert ours.num_ceps == ours.mel_opts.num_bins == 23 and ours.mel_opts.high_freq == -200
    if name == "vad-5.5.conf":
        assert (ours.energy_threshold, ours.energy_mean_scale) == (5.5, 0.5)


@pytest.mark.parametrize("feat_type,line", [
    ("fbank", "--no-such-option=3"), ("mfcc", "--vad-energy-threshold=5"), ("vad", "--num-mel-bins=23"),
    ("pitch", "--num-ceps=13"), ("fbank", "--lpc-order=12"), ("spectrogram", "--num-ceps=13"),
    ("fbank", "num-mel-bins=23"),
])
def test_kaldi_conf_refuses_what_jax_refuses(tmp_path, feat_type, line):
    path = tmp_path / "x.conf"
    path.write_text(line + "\n")
    with pytest.raises(ValueError):
        jf.options_from_kaldi_conf(str(path), feat_type)
    with pytest.raises(ValueError):
        tf.options_from_kaldi_conf(str(path), feat_type)


# -- constants ----------------------------------------------------------------


@pytest.mark.parametrize("num_bins", [23, 80])
@pytest.mark.parametrize("warp", [1.0, 0.85, 0.9, 1.1, 1.15])
def test_vtln_mel_banks_equal_jax(num_bins, warp):
    fo_t, fo_j = tf.FrameOptions(), jf.FrameOptions()
    for mo_t, mo_j in ((_mel(tf, num_bins), _mel(jf, num_bins)),
                       (tf.MelOptions(num_bins=num_bins, low_freq=40, high_freq=-200, vtln_low=200, vtln_high=7000),
                        jf.MelOptions(num_bins=num_bins, low_freq=40, high_freq=-200, vtln_low=200, vtln_high=7000))):
        np.testing.assert_array_equal(tf.mel_banks(mo_t, fo_t, warp), jf.mel_banks(mo_j, fo_j, warp))
        np.testing.assert_array_equal(tfun.mel_center_freqs(mo_t, fo_t, warp), jfun.mel_center_freqs(mo_j, fo_j, warp))
        np.testing.assert_array_equal(tfun.equal_loudness_coeffs(mo_t, fo_t, warp),
                                      jfun.equal_loudness_coeffs(mo_j, fo_j, warp))
    if warp != 1.0:
        assert not np.array_equal(tf.mel_banks(_mel(tf, num_bins), fo_t, warp), tf.mel_banks(_mel(tf, num_bins), fo_t))


@pytest.mark.parametrize("rows,cols", [(13, 23), (20, 40), (23, 23)])
def test_dct_lifter_and_idft_equal_jax(rows, cols):
    np.testing.assert_array_equal(tf.dct_matrix(rows, cols), jf.dct_matrix(rows, cols))
    np.testing.assert_array_equal(tf.lifter_coeffs(22.0, rows), jf.lifter_coeffs(22.0, rows))
    np.testing.assert_array_equal(tfun.idft_bases(rows, cols + 2), jfun.idft_bases(rows, cols + 2))


def test_durbin_matches_jax_and_solves_yule_walker():
    """The same f32 autocorrelations through both recursions; in f64 the
    port's LPC solves the Yule-Walker equations (Kaldi stores the negated
    predictor, JAX tests/test_features.py:187-205)."""
    from scipy.linalg import toeplitz

    rng = np.random.default_rng(3)
    sig = rng.normal(size=(4, 8000))
    for i in range(4, sig.shape[1]):
        sig[:, i] += 0.6 * sig[:, i - 1] - 0.3 * sig[:, i - 2] + 0.1 * sig[:, i - 3]
    order = 6
    ac = np.stack([[np.dot(s[: len(s) - k], s[k:]) for k in range(order + 1)] for s in sig])
    lpc_t, e_t = tfun._durbin(torch.from_numpy(ac.astype(np.float32)), order)
    lpc_j, e_j = jfun._durbin(jnp.asarray(ac, jnp.float32), order)
    np.testing.assert_allclose(lpc_t.numpy(), np.asarray(lpc_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
    lpc64, e64 = tfun._durbin(torch.from_numpy(ac), order)
    for row, a in zip(ac, lpc64.numpy()):
        np.testing.assert_allclose(a, -np.linalg.solve(toeplitz(row[:order]), row[1: order + 1]), rtol=1e-9,
                                   atol=1e-12)
    assert (e64 > 0).all()
    ceps = tfun._lpc_to_cepstrum(lpc_t)
    np.testing.assert_allclose(ceps.numpy(), np.asarray(jfun._lpc_to_cepstrum(lpc_j)), rtol=1e-5, atol=1e-5)


# -- MFCC ---------------------------------------------------------------------


@pytest.mark.parametrize("num_bins", [23, 80])
@pytest.mark.parametrize("kw", MFCC_OPTIONS)
def test_mfcc_matches_jax_numpy_and_jnp(num_bins, kw):
    wave = _wave(11, (2, 16000))
    ref_opts = jf.MfccOptions(mel_opts=_mel(jf, num_bins), **kw)
    got = tf.compute_mfcc(torch.from_numpy(wave), tf.MfccOptions(mel_opts=_mel(tf, num_bins), **kw),
                          fft_mode="rfft").numpy()
    host = jf.compute_mfcc(wave, ref_opts)
    assert isinstance(host, np.ndarray) and got.shape == host.shape == (2, 98, 13)
    np.testing.assert_allclose(got, host, **JAX_TOL)
    np.testing.assert_allclose(got, np.asarray(jf.compute_mfcc(jnp.asarray(wave), ref_opts)), **JAX_TOL)


def test_mfcc_gemm_mode_and_batch_rows():
    """The default gemm DFT against the rfft one (JAX's 2e-3 for its two
    modes, tests/test_features.py:290-296), and a batch row by row."""
    wave = _wave(12, (3, 12000))
    batch = tf.compute_mfcc(torch.from_numpy(wave))
    np.testing.assert_allclose(batch.numpy(), tf.compute_mfcc(torch.from_numpy(wave), fft_mode="rfft").numpy(),
                               **GOLDEN_TOL)
    for i in range(3):
        np.testing.assert_allclose(tf.compute_mfcc(torch.from_numpy(wave[i])).numpy(), batch[i].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,golden_kw", [
    ({}, {}),
    (dict(use_energy=False), dict(use_energy=False)),
    (dict(raw_energy=False, energy_floor=1.0), dict(raw_energy=False, energy_floor=1.0)),
    (dict(num_ceps=20, mel_opts=None), dict(num_ceps=20, num_bins=40)),
])
def test_mfcc_matches_golden_in_f32_and_f64(kw, golden_kw):
    wave = _wave(13, 16000)
    if "mel_opts" in kw:
        kw = dict(kw, mel_opts=tf.MelOptions(num_bins=40))
    opts = tf.MfccOptions(**kw)
    want = gold.golden_mfcc(wave.astype(np.float64), **golden_kw)
    got32 = tf.compute_mfcc(torch.from_numpy(wave), opts, fft_mode="rfft")
    got64 = tf.compute_mfcc(torch.from_numpy(wave.astype(np.float64)), opts, fft_mode="rfft")
    assert got32.dtype == torch.float32 and got64.dtype == torch.float64
    np.testing.assert_allclose(got32.numpy(), want, **GOLDEN_TOL)
    np.testing.assert_allclose(got64.numpy(), want, **F64_TOL)


def test_mfcc_dither_and_snip_edges_match_jax():
    """Dither from numpy Generators of one seed on both sides, and frames
    centred without snipping the edges."""
    wave = _wave(14, 20000)
    fo_t, fo_j = tf.FrameOptions(dither=1.0, snip_edges=False), jf.FrameOptions(dither=1.0, snip_edges=False)
    got = tf.compute_mfcc(torch.from_numpy(wave), tf.MfccOptions(frame_opts=fo_t), rng=np.random.default_rng(5),
                          fft_mode="rfft").numpy()
    ref = jf.compute_mfcc(wave, jf.MfccOptions(frame_opts=fo_j), rng=np.random.default_rng(5))
    assert got.shape == ref.shape == (125, 13)
    np.testing.assert_allclose(got, ref, **JAX_TOL)


@pytest.mark.parametrize("num_bins", [23, 80])
@pytest.mark.parametrize("warp", [0.9, 1.1])
def test_vtln_fbank_matches_jax_pieces(num_bins, warp):
    """The warped log-mel fbank from the port's pieces (frames, power
    spectrum, mel_banks(vtln_warp), log) against the same composition of
    JAX's numpy front end: neither compute_fbank takes a warp."""
    wave = _wave(15, 16000)
    fo = jf.FrameOptions()
    padded, _ = jfun._process_window(jfun.frame_signal(wave, fo), fo, need_raw_energy=False)
    spec = jfun.power_spectrum(padded, fo, keep_bins=256, fft_mode="rfft")
    logmel = np.log(np.maximum(spec @ jf.mel_banks(_mel(jf, num_bins), fo, warp), jf.EPSILON))
    fo_t = tf.FrameOptions()
    padded_t, _ = tfun._frames_and_energy(torch.from_numpy(wave), fo_t, False, True, None)
    spec_t = tf.power_spectrum(padded_t, fo_t, keep_bins=256, fft_mode="rfft")
    got = torch.log(torch.clamp_min(spec_t @ torch.from_numpy(tf.mel_banks(_mel(tf, num_bins), fo_t, warp)),
                                    tf.EPSILON)).numpy()
    np.testing.assert_allclose(got, logmel, **JAX_TOL)


# -- spectrogram --------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(raw_energy=False), dict(energy_floor=1.0)])
def test_spectrogram_matches_jax_numpy_and_jnp(kw):
    wave = _wave(16, (2, 16000))
    ref_opts = jf.SpectrogramOptions(**kw)
    got = tf.compute_spectrogram(torch.from_numpy(wave), tf.SpectrogramOptions(**kw), fft_mode="rfft").numpy()
    host = jf.compute_spectrogram(wave, ref_opts)
    assert got.shape == host.shape == (2, 98, 257)
    np.testing.assert_allclose(got, host, **JAX_TOL)
    np.testing.assert_allclose(got, np.asarray(jf.compute_spectrogram(jnp.asarray(wave), ref_opts)), **JAX_TOL)


def test_spectrogram_f64_matches_the_golden_fbank_spectrum():
    """The float64 spectrogram's bins 1..255 against the golden's log
    power spectrum (its rfft in float64), column 0 the raw log energy."""
    wave = _wave(17, 8000).astype(np.float64)
    got = tf.compute_spectrogram(torch.from_numpy(wave), fft_mode="rfft").numpy()
    frames = gold.golden_frames(wave)
    win = gold.window_vec(400)
    for t in (0, 20, len(frames) - 1):
        x = frames[t] - frames[t].mean()
        energy = np.log(max(np.dot(x, x), gold.EPS))
        y = np.concatenate([[x[0] * 0.03], x[1:] - 0.97 * x[:-1]]) * win
        power = np.abs(np.fft.rfft(np.pad(y, (0, 112)))) ** 2
        np.testing.assert_allclose(got[t], np.concatenate([[energy], np.log(np.maximum(power[1:], gold.EPS))]),
                                   **F64_TOL)


# -- PLP ----------------------------------------------------------------------


@pytest.mark.parametrize("num_bins", [23, 80])
@pytest.mark.parametrize("kw", [{}, dict(htk_compat=True), dict(use_energy=False), dict(energy_floor=1.0),
                                dict(raw_energy=False), dict(cepstral_scale=2.0, lpc_order=16, num_ceps=15)])
def test_plp_matches_jax(num_bins, kw):
    wave = _wave(18, (2, 8000), scale=1000.0)
    ours = tf.compute_plp(torch.from_numpy(wave), tf.PlpOptions(mel_opts=_mel(tf, num_bins), **kw),
                          fft_mode="rfft").numpy()
    ref = np.asarray(jf.compute_plp(jnp.asarray(wave), jf.PlpOptions(mel_opts=_mel(jf, num_bins), **kw)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **JAX_TOL)


@pytest.mark.parametrize("num_bins", [23, 80])
@pytest.mark.parametrize("warp", [0.9, 1.1])
def test_vtln_plp_matches_jax(num_bins, warp):
    wave = _wave(19, 8000, scale=1000.0)
    ours = tf.compute_plp(torch.from_numpy(wave), tf.PlpOptions(mel_opts=_mel(tf, num_bins)), fft_mode="rfft",
                          vtln_warp=warp).numpy()
    ref = np.asarray(jf.compute_plp(jnp.asarray(wave), jf.PlpOptions(mel_opts=_mel(jf, num_bins)), vtln_warp=warp))
    np.testing.assert_allclose(ours, ref, **JAX_TOL)
    plain = tf.compute_plp(torch.from_numpy(wave), tf.PlpOptions(mel_opts=_mel(tf, num_bins)), fft_mode="rfft")
    assert not np.allclose(ours, plain.numpy(), **JAX_TOL)


@pytest.mark.parametrize("kw,golden_kw", [
    ({}, {}),
    (dict(use_energy=False), dict(use_energy=False)),
    (dict(lpc_order=10, num_ceps=11, compress_factor=0.5, cepstral_scale=1.5),
     dict(lpc_order=10, num_ceps=11, compress=0.5, cepstral_scale=1.5)),
    (dict(mel_opts=(40, 40.0, -200.0)), dict(num_bins=40, low_freq=40.0, high_freq=-200.0)),
])
def test_plp_matches_golden_in_f32_and_f64(kw, golden_kw):
    if "mel_opts" in kw:
        n, lo, hi = kw["mel_opts"]
        kw = dict(kw, mel_opts=tf.MelOptions(num_bins=n, low_freq=lo, high_freq=hi))
    wave = _wave(20, 4000, scale=1000.0)
    opts = tf.PlpOptions(**kw)
    want = gold.golden_plp(wave.astype(np.float64), **golden_kw)
    np.testing.assert_allclose(tf.compute_plp(torch.from_numpy(wave), opts).numpy(), want, **GOLDEN_TOL)
    got64 = tf.compute_plp(torch.from_numpy(wave.astype(np.float64)), opts, fft_mode="rfft")
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want, **F64_TOL)


# -- the host stage -----------------------------------------------------------


@pytest.mark.parametrize("feat_type", ["fbank", "mfcc", "fbank_pitch", "mfcc_pitch"])
@pytest.mark.parametrize("cmvn", [True, False])
def test_compute_feats_matches_jax(feat_type, cmvn):
    """data/processor.py compute_feats against JAX's numpy stage: pitch of
    the f64 wave, both cut to the shorter, CMVN over the concatenation."""
    rng = np.random.default_rng(21)
    t = np.arange(20000) / 16000.0
    samples = [{"key": f"u{i}", "sample_rate": 16000,
                "wav": (3000 * np.sin(2 * np.pi * (120 + 40 * i) * t) + rng.normal(size=t.size) * 300
                        ).astype(np.float32)} for i in range(2)]
    opts_t = opts_j = None
    if feat_type.startswith("mfcc"):
        opts_t, opts_j = tf.MfccOptions(mel_opts=_mel(tf, 30)), jf.MfccOptions(mel_opts=_mel(jf, 30))
    got = list(tproc.compute_feats(opts_t, feat_type=feat_type, cmvn=cmvn)([dict(s) for s in samples]))
    ref = list(jproc.compute_feats(opts_j, feat_type=feat_type, cmvn=cmvn)([dict(s) for s in samples]))
    for g, r in zip(got, ref):
        assert g["feat"].dtype == np.float32 and g["feat"].shape == r["feat"].shape
        assert g["feat"].shape[1] == (23 if feat_type.startswith("fbank") else 13) + 3 * feat_type.endswith("pitch")
        np.testing.assert_allclose(g["feat"], r["feat"], **JAX_TOL)
