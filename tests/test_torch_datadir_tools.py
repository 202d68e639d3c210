"""The port's data-dir tools (asv_subtools_tpu_torch.datadir) and offline
augmentation (asv_subtools_tpu_torch.offline_aug) against the JAX
package's, exactly: the same tables key for key, the same trials and
feature matrices row for row, the same written datadir and the same
16-bit wavs byte for byte. Both draw from random.Random(seed) or
np.random.default_rng(seed), so one seed gives one result. The data dirs,
feature tables and manifests are made with numpy from a seed (the
manifests as tests/test_offline_aug.py builds them).
"""

import os

import numpy as np
import pytest

from asv_subtools_tpu import datadir as jd
from asv_subtools_tpu import offline_aug as jaug
from asv_subtools_tpu.io.kaldi import write_mat, write_vec_flt
from asv_subtools_tpu.io.wav import write_wav
from asv_subtools_tpu_torch import datadir as td
from asv_subtools_tpu_torch import offline_aug as taug

SR = 16000


def _tables(num_spks=5, per_spk=(1, 4), seed=0):
    rng = np.random.default_rng(seed)
    wav, u2s, u2f = {}, {}, {}
    for s in range(num_spks):
        for i in range(int(rng.integers(per_spk[0], per_spk[1] + 1))):
            utt = f"spk{s}-utt{i:02d}"
            wav[utt] = f"/data/{utt}.wav"
            u2s[utt] = f"spk{s}"
            u2f[utt] = str(int(rng.integers(50, 400)))
    return {"wav.scp": wav, "utt2spk": u2s, "utt2num_frames": u2f}


def _pair(seed=0):
    tables = _tables(seed=seed)
    return td.DataDir({k: dict(v) for k, v in tables.items()}), jd.DataDir({k: dict(v) for k, v in tables.items()})


def _same(a, b):
    assert a.tables == b.tables and a.utts == b.utts and a.speakers == b.speakers


@pytest.mark.parametrize("seed", [0, 7, 1024])
def test_datadir_methods_equal_jax(seed):
    ours, ref = _pair(seed)
    _same(ours.filter_speakers(["spk1", "spk3"]), ref.filter_speakers(["spk1", "spk3"]))
    _same(ours.add_prefix("sp1.1-"), ref.add_prefix("sp1.1-"))
    _same(ours.add_prefix("rev-", also_spk=False), ref.add_prefix("rev-", also_spk=False))
    for kw in (dict(num_utts=5), dict(num_spks=2), dict(num_utts=2, per_spk=True), {}):
        _same(ours.subset(seed=seed, **kw), ref.subset(seed=seed, **kw))
    for a, b in zip(ours.split_by_length(200), ref.split_by_length(200)):
        _same(a, b)
    other_t, other_j = _pair(seed + 1)
    _same(ours.combine(other_t.add_prefix("x-")), ref.combine(other_j.add_prefix("x-")))
    for nj in (1, 3, 4):
        parts_t, parts_j = ours.split(nj), ref.split(nj)
        assert len(parts_t) == len(parts_j) == nj
        for a, b in zip(parts_t, parts_j):
            _same(a, b)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("counts", [(10, 10), (3, 1)])
def test_trials_and_enroll_test_split_equal_jax(seed, counts):
    ours, ref = _pair(seed)
    trials = td.generate_trials(ours, *counts, seed=seed)
    assert trials == jd.generate_trials(ref, *counts, seed=seed)
    assert any(t[2] == 1 for t in trials) and any(t[2] == 0 for t in trials)
    for a, b in zip(td.split_enroll_test_by_trials(ours, trials), jd.split_enroll_test_by_trials(ref, trials)):
        _same(a, b)


def _feats(seed, dims=(20, 3)):
    rng = np.random.default_rng(seed)
    utts = [f"spk{i % 3}-u{i}" for i in range(7)]
    return [{u: rng.standard_normal((int(rng.integers(30, 90)) + j, d)).astype(np.float32) for u in utts}
            for j, d in enumerate(dims)]


def _same_mats(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 5])
def test_feature_tools_equal_jax(seed):
    fbank, pitch = _feats(seed)
    pitch.pop(next(iter(pitch)))  # an utterance missing from one table
    _same_mats(td.paste_feats([fbank, pitch]), jd.paste_feats([fbank, pitch]))
    u2s = {u: u.split("-")[0] for u in fbank}
    _same_mats(td.concat_sp_feats(fbank, u2s), jd.concat_sp_feats(fbank, u2s))
    _same_mats(td.select_feats(fbank, [0, 5, 19]), jd.select_feats(fbank, [0, 5, 19]))
    _same_mats(td.cut_utt_random(fbank, 50, seed=seed), jd.cut_utt_random(fbank, 50, seed=seed))


def test_frame_counts_from_arks_equal_jax(tmp_path):
    fbank, _ = _feats(1)
    scp = {}
    with open(tmp_path / "feats.ark", "wb") as ark:
        for k, m in fbank.items():
            scp[k] = write_mat(ark, m, k)
    with open(tmp_path / "feats.scp", "w") as f:
        f.writelines(f"{k} {tmp_path / 'feats.ark'}:{off}\n" for k, off in scp.items())
    with open(tmp_path / "vad.ark", "wb") as ark:
        scp = {k: write_vec_flt(ark, (m[:, 0] > 0).astype(np.float32), k) for k, m in fbank.items()}
    with open(tmp_path / "vad.scp", "w") as f:
        f.writelines(f"{k} {tmp_path / 'vad.ark'}:{off}\n" for k, off in scp.items())
    want = {k: m.shape[0] for k, m in fbank.items()}
    assert td.utt2num_frames_from_feats(str(tmp_path / "feats.scp")) == jd.utt2num_frames_from_feats(
        str(tmp_path / "feats.scp")) == want
    assert td.utt2num_frames_from_vad(str(tmp_path / "vad.scp")) == jd.utt2num_frames_from_vad(
        str(tmp_path / "vad.scp")) == want


@pytest.fixture()
def clean_dir(tmp_path):
    rng = np.random.default_rng(0)
    d, w = tmp_path / "clean", tmp_path / "wavs"
    os.makedirs(d)
    os.makedirs(w)
    wav_scp, utt2spk, vad, u2f = {}, {}, {}, {}
    for i in range(6):
        utt = f"utt{i}"
        path = str(w / f"{utt}.wav")
        write_wav(path, (rng.normal(size=SR // 2) * 3000).astype(np.float32), SR)
        wav_scp[utt], utt2spk[utt], vad[utt], u2f[utt] = path, f"spk{i % 3}", f"fake_ark:{i}", "48"
    jd.DataDir({"wav.scp": wav_scp, "utt2spk": utt2spk, "vad.scp": vad, "utt2num_frames": u2f}).write(str(d))
    return str(d)


@pytest.fixture()
def manifests(tmp_path):
    rng = np.random.default_rng(1)
    out = {}
    for kind, n in [("rir", 2), ("noise", 3), ("music", 2), ("babble", 4)]:
        rows = ["ID,duration,wav,wav_format,type"]
        for i in range(n):
            p = str(tmp_path / f"{kind}{i}.wav")
            if kind == "rir":
                sig = np.zeros(1600, np.float32)
                sig[0], sig[200] = 1.0, 0.4
            else:
                sig = (rng.normal(size=SR) * 2000).astype(np.float32)
            write_wav(p, sig, SR)
            rows.append(f"{kind}{i},1.0,{p},wav,{kind}")
        with open(tmp_path / f"{kind}.csv", "w") as f:
            f.write("\n".join(rows) + "\n")
        out[kind] = str(tmp_path / f"{kind}.csv")
    return out


def _written(root):
    """Every file under root, by its path from root: its bytes, with the
    root's own path taken out of the text files (the scp lines)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read().replace(root.encode(), b"ROOT")
    return out


@pytest.mark.parametrize("kinds,factor,seed", [
    (("rir", "noise", "music", "babble"), 2.0, 3),
    (("noise", "babble"), 1.0, 1024),
    (("rir",), 1.0, 0),
])
def test_augment_data_dir_equals_jax(clean_dir, manifests, tmp_path, kinds, factor, seed):
    args = {f"{'reverb' if k == 'rir' else k}_csv": manifests[k] for k in kinds}
    ours = taug.augment_data_dir(clean_dir, str(tmp_path / "port"), factor=factor, seed=seed, **args)
    ref = jaug.augment_data_dir(clean_dir, str(tmp_path / "jax"), factor=factor, seed=seed, **args)
    assert len(ours) == len(ref) == 6 + int(6 * min(factor, len(kinds)))
    got, want = _written(str(tmp_path / "port")), _written(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and got == want
    assert ours.tables == {name: {k: v.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for k, v in t.items()}
                           for name, t in ref.tables.items()}


def test_augmented_vad_and_sp3way_equal_jax(clean_dir, manifests, tmp_path):
    for side, aug in (("port", taug), ("jax", jaug)):
        aug.augment_data_dir(clean_dir, str(tmp_path / side), noise_csv=manifests["noise"],
                             music_csv=manifests["music"], factor=2.0, seed=5)
        with open(tmp_path / f"clean_vad_{side}.scp", "w") as f:
            f.writelines(f"utt{i} vad.ark:{10 * i}\n" for i in range(5))  # utt5 has no clean VAD
        aug.compute_augmented_vad(str(tmp_path / side), str(tmp_path / f"clean_vad_{side}.scp"))
    for name in ("vad.scp", "lost_clean.utts"):
        with open(tmp_path / "port" / name) as a, open(tmp_path / "jax" / name) as b:
            text = a.read()
            assert text == b.read() and text
    tables = {"utt2spk": {"sp0.9-utt1": "sp0.9-spk1", "utt1": "spk1", "sp1.1-utt2": "sp1.1-spk2"},
              "wav.scp": {"sp0.9-utt1": "a.wav", "utt1": "b.wav", "sp1.1-utt2": "c.wav"}}
    ours = taug.correct_speaker_after_sp3way(td.DataDir({k: dict(v) for k, v in tables.items()}))
    ref = jaug.correct_speaker_after_sp3way(jd.DataDir({k: dict(v) for k, v in tables.items()}))
    assert ours.tables == ref.tables and ours.tables["utt2spk"]["utt1-sp0.9"] == "spk1"
