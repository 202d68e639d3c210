"""The native (C++) host front end through the port (features/native.py).

* ``native_fbank`` and ``native_mfcc`` against JAX's ``compute_fbank`` and
  ``compute_mfcc`` at tests/test_runtime_parity.py's tolerances (fbank
  1e-3, MFCC 2e-3).
* ``compute_feats(backend="native")`` through ``WavEgsXvector`` and
  through 2 spawned ``MultiprocessLoader`` workers (each loads the library
  itself) against the numpy backend at 2e-3 (JAX tests/test_data.py:
  826-900); ``fbank_pitch`` on native.
* An option the C API cannot express: ``"native"`` raises ValueError
  naming it, ``"auto"`` computes with the torch path (JAX's choice).
* The library builds into the port's build directory; a failed build
  raises with the compiler's output.

Everything here needs a C++ compiler; the module skips only when there
is no ``c++`` on PATH.
"""

import functools
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from asv_subtools_tpu.features import FbankOptions as JaxFbankOptions
from asv_subtools_tpu.features import MelOptions as JaxMelOptions
from asv_subtools_tpu.features import MfccOptions as JaxMfccOptions
from asv_subtools_tpu.features import compute_fbank as jax_compute_fbank
from asv_subtools_tpu.features import compute_mfcc as jax_compute_mfcc
from asv_subtools_tpu_torch.data import WavEgsXvector
from asv_subtools_tpu_torch.features import native
from asv_subtools_tpu_torch.features.config import FbankOptions, FrameOptions, MelOptions, MfccOptions
from asv_subtools_tpu_torch.kernels import _build
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus

pytestmark = pytest.mark.skipif(shutil.which("c++") is None, reason="no C++ compiler (c++) on PATH")


def _wave(seed, n=8000):
    return (np.random.default_rng(seed).normal(size=n) * 1000).astype(np.float32)


def test_native_available_and_built_in_the_port():
    assert native.native_available()
    assert _build.CAPI_LIB.parent == _build.BUILD_DIR and _build.CAPI_LIB.exists()
    assert "runtime" not in _build.CAPI_LIB.parent.parts[-2:]


@pytest.mark.parametrize("num_bins", [23, 40, 80])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_fbank_matches_jax(num_bins, seed):
    w = _wave(seed, 8000 + 137 * seed)
    got = native.native_fbank(w, FbankOptions(mel_opts=MelOptions(num_bins=num_bins)))
    want = np.asarray(jax_compute_fbank(jnp.asarray(w), JaxFbankOptions(mel_opts=JaxMelOptions(num_bins=num_bins))))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("use_energy", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_mfcc_matches_jax(use_energy, seed):
    w = _wave(10 + seed)
    got = native.native_mfcc(w, MfccOptions(use_energy=use_energy))
    want = np.asarray(jax_compute_mfcc(jnp.asarray(w), JaxMfccOptions(use_energy=use_energy)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("torch_native_corpus")), num_spks=2, train_per_spk=3)


@pytest.mark.parametrize("feat_type", ["fbank", "mfcc", "fbank_pitch"])
def test_compute_feats_native_matches_numpy_through_the_extractor_egs(corpus, feat_type):
    scp = os.path.join(corpus, "train", "wav.scp")
    a = dict(iter(WavEgsXvector(scp, feat_type=feat_type)))
    b = dict(iter(WavEgsXvector(scp, feat_type=feat_type, feat_backend="native")))
    assert a.keys() == b.keys() and len(a) == 6
    for k in a:
        assert a[k].shape == b[k].shape
        np.testing.assert_allclose(b[k], a[k], rtol=2e-3, atol=2e-3)


def test_compute_feats_native_in_two_spawn_workers(corpus):
    from asv_subtools_tpu_torch.data import MultiprocessLoader, build_spk2int
    from asv_subtools_tpu_torch.data.dataset import _build_train_egs

    u2s = os.path.join(corpus, "train", "utt2spk")

    def batches(backend):
        cfg = dict(train_scp=os.path.join(corpus, "train", "wav.scp"), train_u2s=u2s, spk2int=build_spk2int(u2s),
                   chunk_seconds=0.5, batch_size=2, compute_feat=True, feat_backend=backend, shuffle_buffer=8)
        loader = MultiprocessLoader(functools.partial(_build_train_egs, cfg), num_workers=2)
        try:
            return {k: b["x"][i] for b in loader for i, k in enumerate(b["keys"])}
        finally:
            loader.close()

    a, b = batches("numpy"), batches("native")
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        assert a[k].shape == b[k].shape
        np.testing.assert_allclose(b[k], a[k], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("opts,option", [
    (FbankOptions(frame_opts=FrameOptions(dither=1.0)), "dither"),
    (FbankOptions(frame_opts=FrameOptions(window_type="hamming")), "window_type"),
    (FbankOptions(mel_opts=MelOptions(low_freq=40.0)), "low_freq"),
    (FbankOptions(use_energy=True), "use_energy"),
])
def test_native_raises_on_what_the_c_api_cannot_express(opts, option):
    from asv_subtools_tpu_torch.data.processor import compute_feats

    with pytest.raises(ValueError, match=option):
        native.native_fbank(_wave(0), opts)
    with pytest.raises(ValueError, match=option):
        compute_feats(opts, backend="native")


def test_auto_takes_the_torch_path_where_native_cannot_serve():
    from asv_subtools_tpu_torch.data.processor import compute_feats

    opts = FbankOptions(frame_opts=FrameOptions(dither=0.0, window_type="hamming"))
    sample = lambda: [{"key": "u", "wav": _wave(3), "sample_rate": 16000}]  # noqa: E731
    auto = next(compute_feats(opts, backend="auto")(sample()))["feat"]
    numpy_path = next(compute_feats(opts, backend="numpy")(sample()))["feat"]
    np.testing.assert_array_equal(auto, numpy_path)
    plain = FbankOptions()
    auto = next(compute_feats(plain, backend="auto")(sample()))["feat"]
    nat = next(compute_feats(plain, backend="native")(sample()))["feat"]
    np.testing.assert_array_equal(auto, nat)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ("-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="no_such_header"):
        _build.build_capi(tmp_path / "libasvtpu_capi.so")
    assert not list(tmp_path.iterdir())  # nothing half-written is left


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.build_capi(tmp_path / "libasvtpu_capi.so")


def test_threads_that_ask_at_once_build_once(tmp_path, monkeypatch):
    """The loader's threads reach ``load`` together on a fresh checkout:
    one builds, every thread gets the same library, no temporary is left."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(_build, "CAPI_LIB", tmp_path / "libasvtpu_capi.so")
    monkeypatch.setattr(native, "_LIB", None)
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda _: native.load(), range(4)))
    assert all(lib is libs[0] for lib in libs)
    assert [p.name for p in tmp_path.iterdir()] == ["libasvtpu_capi.so"]
    np.testing.assert_allclose(native.native_fbank(_wave(0), FbankOptions()),
                               jax_compute_fbank(jnp.asarray(_wave(0)), JaxFbankOptions()), rtol=1e-3, atol=1e-3)
