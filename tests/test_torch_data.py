"""The port's data plane against the JAX package's, on a synthetic corpus
the test writes (recipes/synthetic.py: sinusoid-mixture speakers, as in
tests/test_launcher.py).

* Wave egs: bit for bit. The port's data modules are copies of the JAX
  ones (numpy and scipy), so the same scp, seed and epoch give identical
  batches: x, y, mask and keys are compared with np.array_equal over two
  epochs, with speed perturbation, random chunks, the shuffle buffer and a
  speech_aug chain (noise, reverb, drop_freq over csvs the test writes).
* Host features (compute_feat=True, 40 bins, host SpecAugment): the port
  computes the fbank with torch on the CPU, JAX with numpy; held to atol
  2e-5, rtol 1e-5 (the fbank tolerance of tests/test_torch_features.py),
  and the SpecAugment bands (frames and bins of exact zeros) must be the
  same.
* DataDir.valid_split, the Kaldi readers both ways, the Prefetcher's
  pinned hand-over, and MultiprocessLoader's spawn workers: the same
  multiset of batches as the workers' pipelines run in process, with the
  card hidden from the workers (and not from this process), no torch
  imported there, and each worker's end-of-epoch report saying so.
"""

import os
import sys

import numpy as np
import pytest

from asv_subtools_tpu import datadir as jax_datadir
from asv_subtools_tpu import io as jax_io
from asv_subtools_tpu.data import dataset as jax_dataset
from asv_subtools_tpu.data.augment import speech_aug_from_config as jax_speech_aug
from asv_subtools_tpu.features import FbankOptions as JaxFbankOptions
from asv_subtools_tpu.features import MelOptions as JaxMelOptions
from asv_subtools_tpu_torch import datadir, io
from asv_subtools_tpu_torch.data import MultiprocessLoader, Prefetcher, WavEgs, build_spk2int, dataset
from asv_subtools_tpu_torch.data.augment import speech_aug_from_config
from asv_subtools_tpu_torch.features import FbankOptions, MelOptions
from asv_subtools_tpu_torch.recipes.synthetic import write_corpus

SR = 16000


def _noise_csvs(root):
    rng = np.random.default_rng(11)
    rows = {"noise": [], "rir": []}
    for kind, n, length in (("noise", 3, 24000), ("rir", 2, 800)):
        for i in range(n):
            x = rng.normal(size=length) * (2000.0 if kind == "noise" else 1.0)
            if kind == "rir":
                x = x * np.exp(-np.arange(length) / 150.0) * 8000.0
            path = os.path.join(root, f"{kind}{i}.wav")
            io.write_wav(path, x.astype(np.float32), SR)
            rows[kind].append(f"{kind}{i},{length / SR},{path}")
    for kind, lines in rows.items():
        with open(os.path.join(root, f"{kind}.csv"), "w") as f:
            f.write("id,duration,wav\n" + "\n".join(lines) + "\n")
    return os.path.join(root, "noise.csv"), os.path.join(root, "rir.csv")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data_corpus"))
    write_corpus(root)
    noise_csv, rir_csv = _noise_csvs(root)
    return {"root": root, "noise_csv": noise_csv, "rir_csv": rir_csv}


def _speech_aug_cfg(corpus):
    return {"mode": "chain", "stages": [
        {"type": "add_reverb", "csv": corpus["rir_csv"]},
        {"type": "add_noise", "csv": corpus["noise_csv"], "snr_low": 5, "snr_high": 15},
        {"type": "drop_freq"},
    ]}


def _egs_pair(corpus, port_kw=None, ref_kw=None, **kw):
    root = corpus["root"]
    scp, u2s = os.path.join(root, "train", "wav.scp"), os.path.join(root, "train", "utt2spk")
    spk2int = build_spk2int(u2s)
    assert spk2int == jax_dataset.build_spk2int(u2s)
    aug = kw.pop("speech_aug", None)
    common = dict(chunk_seconds=0.8, batch_size=5, shuffle_buffer=7, seed=3, num_spks=len(spk2int), drop_last=False)
    common.update(kw)
    port = WavEgs(scp, u2s, spk2int, aug=speech_aug_from_config(aug), **common, **(port_kw or {}))
    ref = jax_dataset.WavEgs(scp, u2s, spk2int, aug=jax_speech_aug(aug), **common, **(ref_kw or {}))
    return port, ref


def _epochs(egs, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        egs.set_epoch(epoch)
        out.append(list(egs))
    return out


@pytest.mark.parametrize("case", ["chunk_shuffle", "speed_perturb", "speech_aug", "threads"])
def test_wave_egs_bit_for_bit(corpus, case):
    kw = {"chunk_shuffle": {}, "speed_perturb": {"speed_perturb": True},
          "speech_aug": {"speed_perturb": True, "speech_aug": _speech_aug_cfg(corpus)},
          "threads": {"speed_perturb": True, "workers": 3}}[case]
    port, ref = _egs_pair(corpus, **kw)
    got, want = _epochs(port), _epochs(ref)
    assert [len(e) for e in got] == [len(e) for e in want] == [5, 5]
    assert [b["keys"] for b in got[0]] != [b["keys"] for b in got[1]]  # the epoch reshuffles
    for eg, ew in zip(got, want):
        for bg, bw in zip(eg, ew):
            assert bg["keys"] == bw["keys"]
            for k in ("x", "y", "mask"):
                assert bg[k].dtype == bw[k].dtype and np.array_equal(bg[k], bw[k]), k
    if "speed_perturb" in kw:  # labels of the perturbed copies are offset by the speaker count
        assert max(int(b["y"].max()) for e in got for b in e) >= 4


def test_host_features_match_jax(corpus):
    """compute_feat=True at 40 bins with host SpecAugment."""
    port, ref = _egs_pair(corpus, port_kw={"feat_opts": FbankOptions(mel_opts=MelOptions(num_bins=40))},
                          ref_kw={"feat_opts": JaxFbankOptions(mel_opts=JaxMelOptions(num_bins=40))},
                          speed_perturb=True, compute_feat=True, spec_aug=True)
    got, want = _epochs(port), _epochs(ref)
    n = 0
    for eg, ew in zip(got, want):
        for bg, bw in zip(eg, ew):
            assert bg["keys"] == bw["keys"] and bg["x"].shape == bw["x"].shape and bg["x"].shape[-1] == 40
            assert np.array_equal(bg["y"], bw["y"]) and np.array_equal(bg["mask"], bw["mask"])
            for axis in (1, 2):  # SpecAugment's bands: whole frames and whole bins at 0
                assert np.array_equal((bg["x"] == 0).all(axis), (bw["x"] == 0).all(axis))
            np.testing.assert_allclose(bg["x"], bw["x"], atol=2e-5, rtol=1e-5)
            n += int((bg["x"] == 0).all(1).any())
    assert n > 0


@pytest.mark.parametrize("feat_type", ["fbank", "mfcc_pitch"])
def test_compute_feats_native_matches_jax(corpus, feat_type):
    """backend="native" (before ROADMAP item 10 was ported it raised) runs
    the C++ front end and agrees with JAX's native stage (its C++ library
    where it is built, else its numpy path) at 2e-3, with CMVN."""
    from asv_subtools_tpu.data import processor as jax_processor
    from asv_subtools_tpu_torch.data import processor

    with open(os.path.join(corpus["root"], "train", "wav.scp")) as f:
        wav, _ = io.read_wav(f.readline().split()[1])
    sample = lambda: [{"key": "u", "wav": np.asarray(wav, np.float32).reshape(-1), "sample_rate": 16000}]  # noqa
    got = next(processor.compute_feats(feat_type=feat_type, backend="native")(sample()))["feat"]
    want = next(jax_processor.compute_feats(feat_type=feat_type, backend="native")(sample()))["feat"]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1024])
def test_valid_split_matches_jax(corpus, seed):
    path = os.path.join(corpus["root"], "train")
    tr, va = datadir.DataDir.read(path).valid_split(num_utts=5, seed=seed)
    jtr, jva = jax_datadir.DataDir.read(path).valid_split(num_utts=5, seed=seed)
    assert tr.tables == jtr.tables and va.tables == jva.tables and len(va) == 5
    assert all(len(u) >= 2 for u in tr.spk2utt().values())


def test_datadir_write_round_trip(corpus, tmp_path):
    dd = datadir.DataDir.read(os.path.join(corpus["root"], "train"))
    dd.write(str(tmp_path / "copy"))
    jdd = jax_datadir.DataDir.read(str(tmp_path / "copy"))
    assert jdd.tables == dd.tables
    assert (tmp_path / "copy" / "spk2utt").read_text().splitlines()[0].startswith("spk00 s00-u0 s00-u1")


def _vectors(rng, n=4):
    return {f"k{i}": rng.normal(size=7 + i).astype(np.float32) for i in range(n)}


@pytest.mark.parametrize("kind,direction", [(k, d) for k in ("vec", "vec_f64", "mat") for d in
                                            ("jax_writes", "port_writes")] + [("vec_int", "jax_writes")])
def test_kaldi_tables_cross_read(tmp_path, direction, kind):
    """Vector, matrix and (JAX-written: the port writes none) int32 vector
    tables, read through the ark and through the scp offsets."""
    rng = np.random.default_rng(5)
    if kind == "vec":
        data = _vectors(rng)
    elif kind == "vec_f64":
        data = {k: v.astype(np.float64) for k, v in _vectors(rng).items()}
    elif kind == "mat":
        data = {f"k{i}": rng.normal(size=(3 + i, 5)).astype(np.float32) for i in range(3)}
    else:
        data = {f"k{i}": rng.integers(-50, 50, size=6 + i).astype(np.int32) for i in range(3)}
    writer, reader = (jax_io, io) if direction == "jax_writes" else (io, jax_io)
    ark, scp = str(tmp_path / "t.ark"), str(tmp_path / "t.scp")
    with open(ark, "wb") as fd, open(scp, "w") as fs:
        for key, value in data.items():
            write = {"mat": writer.write_mat, "vec_int": jax_io.write_vec_int}.get(kind, writer.write_vec_flt)
            offset = write(fd, value, key)
            fs.write(f"{key} {ark}:{offset}\n")
    read_ark = {"mat": reader.read_mat_ark, "vec_int": reader.read_vec_int_ark}.get(kind, reader.read_vec_flt_ark)
    read_scp = {"mat": reader.read_mat_scp, "vec_int": reader.read_vec_int_scp}.get(kind, reader.read_vec_flt_scp)
    for table in (dict(read_ark(ark)), dict(read_scp(scp))):
        assert list(table) == list(data)
        for key, value in data.items():
            assert table[key].dtype == value.dtype and np.array_equal(table[key], value)


def _compressed(header, rows, cols, rng):
    """A Kaldi compressed matrix's bytes (global header, then the body of
    the format) and the matrix JAX's reader decodes from them."""
    import struct

    body = b"\x00B" + header + struct.pack("<ffii", -3.0, 7.5, rows, cols)
    if header == b"CM ":
        heads = np.sort(rng.integers(0, 65536, size=(cols, 4)), axis=1).astype(np.uint16)
        body += heads.tobytes() + rng.integers(0, 256, size=(cols, rows)).astype(np.uint8).tobytes()
    elif header == b"CM2":
        body += rng.integers(0, 65536, size=(rows, cols)).astype(np.uint16).tobytes()
    else:
        body += rng.integers(0, 256, size=(rows, cols)).astype(np.uint8).tobytes()
    return body


@pytest.mark.parametrize("header", [b"CM ", b"CM2", b"CM3"])
@pytest.mark.parametrize("row_range", [None, (2, 9)])
def test_compressed_matrix_decode_matches_jax(tmp_path, header, row_range):
    path = tmp_path / "cm.mat"
    path.write_bytes(_compressed(header, 11, 6, np.random.default_rng(len(header) + 3)))
    got = io.read_mat(str(path), row_range=row_range)
    want = jax_io.read_mat(str(path), row_range=row_range)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_extractor_writer_read_by_jax(tmp_path):
    """The extractor's vector ark/scp (ArkScpWriter) through JAX's reader."""
    data = _vectors(np.random.default_rng(9), 5)
    with io.ArkScpWriter(str(tmp_path / "x.ark"), str(tmp_path / "x.scp")) as w:
        for key, value in data.items():
            w.write(key, value)
    got = dict(jax_io.read_vec_flt_scp(str(tmp_path / "x.scp")))
    assert list(got) == list(data) and all(np.array_equal(got[k], data[k]) for k in data)


def test_wav_round_trip_matches_jax(tmp_path):
    x = (np.random.default_rng(2).normal(size=(2, 900)) * 8000).astype(np.float32)
    io.write_wav(str(tmp_path / "a.wav"), x, SR)
    jax_io.write_wav(str(tmp_path / "b.wav"), x, SR)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    got, sr = io.read_wav(str(tmp_path / "a.wav"), normalize=True)
    want, _ = jax_io.read_wav(str(tmp_path / "a.wav"), normalize=True)
    assert sr == SR and np.array_equal(got, want)


def test_prefetcher_pins_only_when_asked(corpus):
    import torch

    port, _ = _egs_pair(corpus)
    plain = list(Prefetcher(port))
    assert isinstance(plain[0]["x"], np.ndarray)
    if not torch.cuda.is_available():
        return
    pinned = list(Prefetcher(port, pin_memory=True))
    assert all(b["x"].is_pinned() and np.array_equal(b["x"].numpy(), p["x"]) for b, p in zip(pinned, plain))


def _loader_cfg(corpus, **kw):
    root = corpus["root"]
    u2s = os.path.join(root, "train", "utt2spk")
    cfg = dict(train_scp=os.path.join(root, "train", "wav.scp"), train_u2s=u2s, spk2int=build_spk2int(u2s),
               chunk_seconds=0.8, batch_size=4, speed_perturb=True, compute_feat=False, shuffle_buffer=5, seed=3)
    cfg.update(kw)
    return cfg


def _batch_set(batches):
    return sorted((tuple(b["keys"]), b["x"].tobytes(), b["y"].tobytes(), b["mask"].tobytes()) for b in batches)


def test_multiprocess_loader_matches_in_process_pipelines(corpus):
    """Two spawn workers over two epochs: each epoch yields the multiset of
    the batches the two workers' pipelines give when run in this process."""
    import functools

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_worker_probe import probe_egs

    cfg = _loader_cfg(corpus)
    make = functools.partial(probe_egs, cfg)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    loader = MultiprocessLoader(make, num_workers=2)
    try:
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            got = list(loader)
            want = []
            for w in (0, 1):
                egs = dataset._build_train_egs(cfg, worker_id=w, num_workers=2)
                egs.set_epoch(epoch)
                want += list(egs)
            assert len(got) == len(want) > 0
            assert _batch_set(got) == _batch_set(want)
            pids = {b["pid"] for b in got}
            assert len(pids) == 2 and os.getpid() not in pids and pids == set(loader.worker_pids)
            assert all(b["cuda_visible_devices"] == "" and not b["torch_imported"] for b in got)
            reports = loader.worker_reports[2 * epoch:]
            assert {r["pid"] for r in reports} == pids and all(
                r["cuda_visible_devices"] == "" and not r["torch_imported"] and not r["cuda_initialized"]
                for r in reports)
    finally:
        loader.close()
    assert loader.worker_pids == [] and len(loader.worker_reports) == 4
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == visible  # the workers hid the card from themselves alone
