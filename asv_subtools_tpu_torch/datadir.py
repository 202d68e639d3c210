"""Kaldi data-directory manipulation (the port's own copy of
asv_subtools_tpu/datadir.py, behaviour unchanged; parity: the reference's
top-level shell utilities filterDataDir.sh, removeUtt.sh,
splitDataByLength.sh, split_enroll_test_by_trials.sh, getTrials.sh,
addPrefixForUttID.sh, combine_data.sh, pasteFeats.sh, concatSpFeats.sh,
selectFeats.sh, cutUttRandomFromFeats.sh, get_utt2num_frames_from_*.sh,
subset_data_dir.sh).

A "data dir" is the Kaldi convention: wav.scp / feats.scp / utt2spk /
spk2utt / utt2num_frames / vad.scp keyed by utterance id, held as a small
in-memory table with file round-trips. The random tools draw from
``random.Random(seed)``, as JAX's do, so the same seed gives the same
result.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_KNOWN_FILES = [
    "wav.scp",
    "feats.scp",
    "vad.scp",
    "utt2spk",
    "utt2num_frames",
    "utt2dur",
    "text",
]


class DataDir:
    """In-memory Kaldi data directory."""

    def __init__(self, tables: Optional[Dict[str, Dict[str, str]]] = None):
        self.tables: Dict[str, Dict[str, str]] = tables or {}

    @staticmethod
    def read(path: str) -> "DataDir":
        tables = {}
        for name in _KNOWN_FILES:
            p = os.path.join(path, name)
            if os.path.exists(p):
                table = {}
                with open(p) as f:
                    for line in f:
                        parts = line.strip().split(None, 1)
                        if len(parts) == 2:
                            table[parts[0]] = parts[1]
                tables[name] = table
        return DataDir(tables)

    def write(self, path: str) -> "DataDir":
        os.makedirs(path, exist_ok=True)
        for name, table in self.tables.items():
            with open(os.path.join(path, name), "w") as f:
                for k in sorted(table):
                    f.write(f"{k} {table[k]}\n")
        # regenerate spk2utt
        if "utt2spk" in self.tables:
            spk2utt: Dict[str, List[str]] = {}
            for u, s in sorted(self.tables["utt2spk"].items()):
                spk2utt.setdefault(s, []).append(u)
            with open(os.path.join(path, "spk2utt"), "w") as f:
                for s in sorted(spk2utt):
                    f.write(f"{s} {' '.join(spk2utt[s])}\n")
        return self

    @property
    def utts(self) -> List[str]:
        for name in ("utt2spk", "wav.scp", "feats.scp"):
            if name in self.tables:
                return sorted(self.tables[name])
        return []

    @property
    def speakers(self) -> List[str]:
        if "utt2spk" not in self.tables:
            return []
        return sorted(set(self.tables["utt2spk"].values()))

    def utt2spk(self) -> Dict[str, str]:
        return dict(self.tables.get("utt2spk", {}))

    def spk2utt(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for u, s in self.tables.get("utt2spk", {}).items():
            out.setdefault(s, []).append(u)
        return {s: sorted(us) for s, us in out.items()}

    def __len__(self) -> int:
        return len(self.utts)

    def filter_utts(self, keep: Iterable[str]) -> "DataDir":
        """filterDataDir.sh / removeUtt.sh (inverse)."""
        keep = set(keep)
        return DataDir(
            {
                name: {k: v for k, v in table.items() if k in keep}
                for name, table in self.tables.items()
            }
        )

    def remove_utts(self, remove: Iterable[str]) -> "DataDir":
        remove = set(remove)
        return self.filter_utts([u for u in self.utts if u not in remove])

    def filter_speakers(self, keep: Iterable[str]) -> "DataDir":
        keep = set(keep)
        u2s = self.tables.get("utt2spk", {})
        return self.filter_utts([u for u, s in u2s.items() if s in keep])

    def add_prefix(self, prefix: str, also_spk: bool = True) -> "DataDir":
        """addPrefixForUttID.sh (the augmentation copies' ids)."""
        out = {name: {f"{prefix}{k}": v for k, v in table.items()} for name, table in self.tables.items()}
        if also_spk and "utt2spk" in out:
            out["utt2spk"] = {k: f"{prefix}{v}" for k, v in out["utt2spk"].items()}
        return DataDir(out)

    def subset(self, num_utts: Optional[int] = None, num_spks: Optional[int] = None, seed: int = 1024,
               per_spk: bool = False) -> "DataDir":
        """subset_data_dir.sh: ``num_spks`` random speakers, or ``num_utts``
        random utterances (of each speaker with ``per_spk``)."""
        rng = random.Random(seed)
        if num_spks is not None:
            spks = self.speakers
            rng.shuffle(spks)
            return self.filter_speakers(spks[:num_spks])
        utts = self.utts
        if per_spk and num_utts is not None:
            keep = []
            for _, us in self.spk2utt().items():
                rng.shuffle(us)
                keep += us[:num_utts]
            return self.filter_utts(keep)
        rng.shuffle(utts)
        return self.filter_utts(utts[: num_utts or len(utts)])

    def split_by_length(self, threshold_frames: int) -> Tuple["DataDir", "DataDir"]:
        """splitDataByLength.sh: (short, long) by utt2num_frames."""
        u2f = {k: int(v) for k, v in self.tables.get("utt2num_frames", {}).items()}
        short = [u for u in self.utts if u2f.get(u, 0) < threshold_frames]
        long_ = [u for u in self.utts if u2f.get(u, 0) >= threshold_frames]
        return self.filter_utts(short), self.filter_utts(long_)

    def combine(self, other: "DataDir") -> "DataDir":
        """combine_data.sh / combineVectordir.sh: other's rows win on a
        shared key."""
        out = {}
        for name in set(self.tables) | set(other.tables):
            merged = dict(self.tables.get(name, {}))
            merged.update(other.tables.get(name, {}))
            out[name] = merged
        return DataDir(out)

    def split(self, nj: int) -> List["DataDir"]:
        """split_data.sh: nj contiguous pieces of the sorted utterances."""
        chunks = np.array_split(np.asarray(self.utts, dtype=object), nj)
        return [self.filter_utts(list(c)) for c in chunks]

    def valid_split(
        self, num_utts: int = 1024, min_per_spk: int = 2, seed: int = 1024
    ) -> Tuple["DataDir", "DataDir"]:
        """Train/valid split keeping >=min_per_spk train utts per speaker
        (get_chunk_egs valid-split semantics, samples.py)."""
        rng = random.Random(seed)
        valid: List[str] = []
        s2u = self.spk2utt()
        candidates = []
        for s, us in s2u.items():
            if len(us) > min_per_spk:
                extra = us[:]
                rng.shuffle(extra)
                candidates += extra[: len(us) - min_per_spk]
        rng.shuffle(candidates)
        valid = candidates[:num_utts]
        train = self.remove_utts(valid)
        return train, self.filter_utts(valid)


def generate_trials(datadir: DataDir, num_targets_per_spk: int = 10, num_nontargets_per_utt: int = 10,
                    seed: int = 1024) -> List[Tuple[str, str, int]]:
    """getTrials.sh: (enroll_utt, test_utt, is_target) pairs:
    ``num_targets_per_spk`` random pairs of each speaker with two or more
    utterances, then ``num_nontargets_per_utt`` random partners of each
    utterance, kept where the speakers differ."""
    rng = random.Random(seed)
    utts = datadir.utts
    u2s = datadir.utt2spk()
    trials = []
    for _, us in datadir.spk2utt().items():
        if len(us) < 2:
            continue
        for _ in range(num_targets_per_spk):
            a, b = rng.sample(us, 2)
            trials.append((a, b, 1))
    for u in utts:
        for _ in range(num_nontargets_per_utt):
            v = rng.choice(utts)
            if u2s[v] != u2s[u]:
                trials.append((u, v, 0))
    return trials


def utt2num_frames_from_feats(feats_scp: str) -> Dict[str, int]:
    """get_utt2num_frames_from_feats.sh: frame counts read from the arks."""
    from .io.kaldi import read_mat_scp

    return {k: m.shape[0] for k, m in read_mat_scp(feats_scp)}


def split_enroll_test_by_trials(datadir: DataDir, trials: Sequence[Tuple[str, str, int]]
                                ) -> Tuple[DataDir, DataDir]:
    """split_enroll_test_by_trials.sh: the enroll and the test side of a
    trials list."""
    enroll_utts = {a for a, _, _ in trials}
    test_utts = {b for _, b, _ in trials}
    return datadir.filter_utts(enroll_utts), datadir.filter_utts(test_utts)


def paste_feats(feat_mats: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """pasteFeats.sh: the tables' feature columns side by side (fbank ++
    pitch) for the utterances in every table, cut to the shortest."""
    keys = set(feat_mats[0])
    for t in feat_mats[1:]:
        keys &= set(t)
    out = {}
    for k in keys:
        mats = [t[k] for t in feat_mats]
        n = min(m.shape[0] for m in mats)
        out[k] = np.concatenate([m[:n] for m in mats], axis=1)
    return out


def concat_sp_feats(feats: Dict[str, np.ndarray], utt2spk: Dict[str, str]) -> Dict[str, np.ndarray]:
    """concatSpFeats.sh: each speaker's utterances one after another in
    time (sorted by utterance id), one matrix a speaker."""
    by_spk: Dict[str, List[str]] = {}
    for u, s in utt2spk.items():
        if u in feats:
            by_spk.setdefault(s, []).append(u)
    return {s: np.concatenate([feats[u] for u in sorted(us)], axis=0) for s, us in by_spk.items()}


def select_feats(feats: Dict[str, np.ndarray], columns: Sequence[int]) -> Dict[str, np.ndarray]:
    """selectFeats.sh: a subset of the feature columns."""
    cols = list(columns)
    return {k: v[:, cols] for k, v in feats.items()}


def cut_utt_random(feats: Dict[str, np.ndarray], max_frames: int, seed: int = 1024) -> Dict[str, np.ndarray]:
    """cutUttRandomFromFeats.sh: a random ``max_frames`` cut of each longer
    utterance."""
    rng = random.Random(seed)
    out = {}
    for k, v in feats.items():
        if v.shape[0] > max_frames:
            start = rng.randint(0, v.shape[0] - max_frames)
            out[k] = v[start: start + max_frames]
        else:
            out[k] = v
    return out


def utt2num_frames_from_vad(vad_scp: str) -> Dict[str, int]:
    """get_utt2num_frames_from_vad.sh: frame counts from the VAD arks (one
    entry a frame)."""
    from .io.kaldi import read_vec_flt_scp

    return {k: int(v.shape[0]) for k, v in read_vec_flt_scp(vad_scp)}
