"""Kaldi data-directory table (the port's own copy of the DataDir of
asv_subtools_tpu/datadir.py: read, write and the train/valid hold-out the
Launcher uses; behaviour unchanged).

A "data dir" is the Kaldi convention: wav.scp / feats.scp / utt2spk /
spk2utt / utt2num_frames / vad.scp keyed by utterance id, held as a small
in-memory table with file round-trips.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterable, List, Optional, Tuple

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
