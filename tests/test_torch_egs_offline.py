"""The port's offline chunk egs (data/egs_offline.py) against the JAX
package's, on one feature data dir written from a seed.

* The data dir: 4 speakers x 5 utterances of 220-300 frames x 24, written
  by the port's ArkScpWriter(matrix=True), whose ark equals the JAX
  writer's byte for byte; utt2num_frames, utt2spk; a phone alignment ark
  of int vectors (ali-to-phones' format) and one of one-column float
  matrices.
* prepare_egs_dir (speaker-balanced and sequential, with a validation
  split) writes the same train.egs.csv, valid.egs.csv and info files as
  JAX's, byte for byte; get_info_from_egsdir reads the same.
* ChunkEgs and ChunkEgsMultiTask batches over two epochs equal JAX's bit
  for bit: x, y, keys, aux_y and phone_y, with per-chunk SpecAugment or
  Cutout (drawn from the same generator), the last partial batch kept or
  dropped, and the two-worker split of build_chunk_egs_from_dir.
"""

import os

import numpy as np
import pytest

from asv_subtools_tpu.data import egs_offline as jeo
from asv_subtools_tpu.io.kaldi import ArkScpWriter as JaxArkScpWriter
from asv_subtools_tpu_torch.data import egs_offline as peo
from asv_subtools_tpu_torch.io.kaldi import ArkScpWriter, write_mat, write_vec_int

F = 24


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline_egs")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(17)
    u2s, u2f, ali_int, ali_mat, aux = [], [], [], [], []
    feats = {}
    with ArkScpWriter(str(root / "feats.ark"), str(data / "feats.scp"), matrix=True) as w:
        for spk in range(4):
            mean = rng.normal(size=F) * 2.0
            for i in range(5):
                key = f"s{spk}-u{i}"
                n = int(rng.integers(220, 300))
                feats[key] = (mean + rng.normal(size=(n, F))).astype(np.float32)
                w.write(key, feats[key])
                u2s.append(f"{key} spk{spk}")
                u2f.append(f"{key} {n}")
                phones = rng.integers(0, 10, size=n)
                off = write_vec_int(str(root / "ali.ark"), phones, key)
                ali_int.append(f"{key} {root / 'ali.ark'}:{off}")
                off = write_mat(str(root / "ali_mat.ark"), phones[:, None].astype(np.float32), key)
                ali_mat.append(f"{key} {root / 'ali_mat.ark'}:{off}")
                aux.append(f"{key} {(spk + i) % 3}")
    with JaxArkScpWriter(str(root / "jax_feats.ark"), str(root / "jax_feats.scp")) as w:
        for key, mat in feats.items():
            w.write(key, mat)
    (data / "utt2spk").write_text("\n".join(u2s) + "\n")
    (data / "utt2num_frames").write_text("\n".join(u2f) + "\n")
    (root / "ali.scp").write_text("\n".join(ali_int) + "\n")
    (root / "ali_mat.scp").write_text("\n".join(ali_mat) + "\n")
    (root / "utt2aux").write_text("\n".join(aux) + "\n")
    return root


def test_feature_ark_equals_the_jax_writers(datadir):
    assert (datadir / "feats.ark").read_bytes() == (datadir / "jax_feats.ark").read_bytes()


EGS_CASES = {
    "balanced_valid": dict(chunk_size=100, valid_num_utts=4, valid_chunk_num=2),
    "sequential": dict(chunk_size=64, chunk_type="sequential", overlap=0.5),
    "budget": dict(chunk_size=120, chunk_num_selection=3, valid_num_utts=2, valid_chunk_num=1, seed=5),
    "max_budget": dict(chunk_size=100, chunk_num_selection=-1, scale=2.0),
}


@pytest.mark.parametrize("case", list(EGS_CASES))
def test_prepare_egs_dir_writes_jax_files_byte_for_byte(datadir, tmp_path, case):
    kw = EGS_CASES[case]
    ref = jeo.prepare_egs_dir(str(datadir / "data"), str(tmp_path / "jax"), **kw)
    got = peo.prepare_egs_dir(str(datadir / "data"), str(tmp_path / "port"), **kw)
    assert got == ref == (F, 4)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert ("valid.egs.csv" in names) == ("valid_num_utts" in kw)
    for name in names + ["info/feat_dim", "info/num_targets"]:
        if name != "info":
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    info = peo.get_info_from_egsdir(str(tmp_path / "port"))
    ref_info = jeo.get_info_from_egsdir(str(tmp_path / "jax"))
    assert info[:2] == ref_info[:2]
    assert [os.path.basename(p) if p else p for p in info[2:]] == [os.path.basename(p) if p else p
                                                                    for p in ref_info[2:]]


@pytest.fixture(scope="module")
def egs_dir(datadir):
    jeo.prepare_egs_dir(str(datadir / "data"), str(datadir / "egs"), chunk_size=100, valid_num_utts=4,
                        valid_chunk_num=2)
    return datadir / "egs"


def _assert_batches_equal(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches) > 0
    for p, j in zip(port_batches, jax_batches):
        assert set(p) == set(j)
        for k in j:
            if k == "keys":
                assert p[k] == j[k]
            else:
                assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def _epochs(egs, n=2):
    out = []
    for epoch in range(n):
        egs.set_epoch(epoch)
        out += list(egs)
    return out


EGS_KW = {
    "plain": dict(batch_size=8),
    "specaugment_aux": dict(batch_size=8, aug="specaugment", aug_params={"frequency": 0.3, "frame": 0.2, "rows": 2,
                                                                          "cols": 1}, utt2aux=True),
    "cutout_tail": dict(batch_size=7, aug="cutout", aug_params={"frequency": 0.2, "frame": 0.3}, drop_last=False,
                        seed=9),
    "rank1_of_2": dict(batch_size=5, rank=1, world_size=2, utt2aux=True),
}


@pytest.mark.parametrize("multitask", [None, "ali.scp", "ali_mat.scp"])
@pytest.mark.parametrize("case", list(EGS_KW))
def test_chunk_egs_batches_equal_jax_bit_for_bit(egs_dir, datadir, case, multitask):
    kw = dict(EGS_KW[case])
    if kw.pop("utt2aux", False):
        kw["utt2aux"] = peo.read_utt2label(str(datadir / "utt2aux"))
    jchunks = jeo.read_chunk_csv(str(egs_dir / "train.egs.csv"))
    pchunks = peo.read_chunk_csv(str(egs_dir / "train.egs.csv"))
    assert [vars(c) for c in pchunks] == [vars(c) for c in jchunks]
    if multitask:
        ali = peo.read_ali_scp(str(datadir / multitask))
        assert ali == jeo.read_ali_scp(str(datadir / multitask))
        jegs, pegs = jeo.ChunkEgsMultiTask(jchunks, ali, **kw), peo.ChunkEgsMultiTask(pchunks, ali, **kw)
    else:
        jegs, pegs = jeo.ChunkEgs(jchunks, **kw), peo.ChunkEgs(pchunks, **kw)
    assert len(pegs) == len(jegs)
    port_batches, jax_batches = _epochs(pegs), _epochs(jegs)
    _assert_batches_equal(port_batches, jax_batches)
    if multitask:
        assert port_batches[0]["phone_y"].shape == port_batches[0]["x"].shape[:2]


def test_build_chunk_egs_from_dir_splits_like_jax(egs_dir, datadir):
    cfg = dict(train_csv=str(egs_dir / "train.egs.csv"), batch_size=4, aug="specaugment",
               ali_scp=str(datadir / "ali.scp"), aux_utt2label=str(datadir / "utt2aux"), seed=3)
    for worker in range(2):
        pegs = peo.build_chunk_egs_from_dir(cfg, worker_id=worker, num_workers=2)
        jegs = jeo.build_chunk_egs_from_dir(cfg, worker_id=worker, num_workers=2)
        assert type(pegs).__name__ == type(jegs).__name__ == "ChunkEgsMultiTask"
        _assert_batches_equal(_epochs(pegs), _epochs(jegs))
    plain = peo.build_chunk_egs_from_dir(dict(train_csv=cfg["train_csv"], batch_size=4))
    assert type(plain) is peo.ChunkEgs and "aux_y" not in next(iter(plain))


def test_chunk_samples_match_jax(datadir):
    from asv_subtools_tpu.datadir import DataDir as JaxDataDir
    from asv_subtools_tpu_torch.datadir import DataDir

    for kw in (dict(chunk_size=128), dict(chunk_size=200, chunk_type="sequential", overlap=0.25)):
        ref = jeo.ChunkSamples(JaxDataDir.read(str(datadir / "data")), **kw).sample()
        got = peo.ChunkSamples(DataDir.read(str(datadir / "data")), **kw).sample()
        assert [vars(c) for c in got] == [vars(c) for c in ref] and got
    with pytest.raises(ValueError):
        peo.ChunkSamples(DataDir.read(str(datadir / "data")), chunk_type="nope").sample()
