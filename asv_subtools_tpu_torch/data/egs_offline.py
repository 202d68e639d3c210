"""Offline chunk egs: fixed-length chunks over precomputed Kaldi feature
arks (the port's own numpy copy; counterpart:
asv_subtools_tpu/data/egs_offline.py, behaviour unchanged; parity:
pytorch/libs/egs/{kaldi_dataset,samples,egs}.py +
pipeline/onestep/get_chunk_egs.py).

``prepare_egs_dir`` turns a feature data dir (feats.scp, utt2num_frames,
utt2spk) into an egs dir: ``train.egs.csv`` (and ``valid.egs.csv``) of
chunks ``utt rxfile start end label`` and ``info/{feat_dim,num_targets}``.
``ChunkSamples`` draws the chunk table (speaker-balanced or sequential);
``ChunkEgs`` reads each chunk's rows from its ark and yields fixed-shape
numpy batches in a seeded order per epoch (``default_rng(seed + epoch)``),
``rank::world_size`` of it; ``ChunkEgsMultiTask`` adds frame-aligned
phone labels from an alignment ark. Host-side numpy only: the loader's
spawn workers build these and never touch the card.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..datadir import DataDir
from ..io.kaldi import read_ali, read_mat


@dataclasses.dataclass
class Chunk:
    utt: str
    rxfile: str
    start: int
    end: int  # exclusive
    label: int


class ChunkSamples:
    """The chunk table (parity: ChunkSamples.__sample samples.py:23-170).

    ``chunk_type`` "speaker_balance": every speaker gets the same number of
    chunks (drawn with replacement from its usable utterances);
    "sequential": every utterance tiled with ``overlap`` between chunks.
    ``chunk_num_selection``: 0 = mean chunks a speaker times ``scale``,
    -1 = the maximum, n > 0 = n.
    """

    def __init__(self, datadir: DataDir, chunk_size: int = 200, chunk_type: str = "speaker_balance",
                 chunk_num_selection: int = 0, overlap: float = 0.1, scale: float = 1.5, seed: int = 1024,
                 spk2int: Optional[Dict[str, int]] = None):
        self.datadir = datadir
        self.chunk_size = chunk_size
        self.chunk_type = chunk_type
        self.chunk_num_selection = chunk_num_selection
        self.overlap = overlap
        self.scale = scale
        self.seed = seed
        spks = sorted(set(datadir.utt2spk().values()))
        self.spk2int = spk2int or {s: i for i, s in enumerate(spks)}

    def sample(self) -> List[Chunk]:
        rng = random.Random(self.seed)
        feats = self.datadir.tables.get("feats.scp", {})
        u2f = {k: int(v) for k, v in self.datadir.tables.get("utt2num_frames", {}).items()}
        u2s = self.datadir.utt2spk()
        cs = self.chunk_size
        chunks: List[Chunk] = []

        if self.chunk_type == "sequential":
            step = max(1, int(cs * (1.0 - self.overlap)))
            for utt in self.datadir.utts:
                if utt not in feats:
                    continue
                start = 0
                while start + cs <= u2f.get(utt, 0):
                    chunks.append(Chunk(utt, feats[utt], start, start + cs, self.spk2int[u2s[utt]]))
                    start += step
            return chunks
        if self.chunk_type != "speaker_balance":
            raise ValueError(f"unknown chunk_type {self.chunk_type!r}")

        s2u = self.datadir.spk2utt()
        per_spk_avail = {s: sum(max(0, u2f.get(u, 0) // cs) for u in us) for s, us in s2u.items()}
        if self.chunk_num_selection > 0:
            budget = self.chunk_num_selection
        elif self.chunk_num_selection == -1:
            budget = max(per_spk_avail.values() or [0])
        else:
            vals = [v for v in per_spk_avail.values() if v > 0]
            budget = int(np.mean(vals) * self.scale) if vals else 0
        for s, us in s2u.items():
            usable = [u for u in us if u in feats and u2f.get(u, 0) >= cs]
            if not usable:
                continue
            for _ in range(max(1, budget)):
                utt = rng.choice(usable)
                start = rng.randint(0, u2f[utt] - cs)
                chunks.append(Chunk(utt, feats[utt], start, start + cs, self.spk2int[u2s[utt]]))
        rng.shuffle(chunks)
        return chunks

    def write_csv(self, path: str, chunks: Optional[List[Chunk]] = None) -> None:
        chunks = chunks if chunks is not None else self.sample()
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["utt", "rxfile", "start", "end", "label"])
            for c in chunks:
                w.writerow([c.utt, c.rxfile, c.start, c.end, c.label])


def get_info_from_egsdir(egsdir: str, train_csv_name: Optional[str] = None,
                         valid_csv_name: Optional[str] = None) -> Tuple[int, int, str, Optional[str]]:
    """(feat_dim, num_targets, train csv, valid csv or None) of an egs dir
    (parity: get_info_from_egsdir, pytorch/libs/egs/egs.py:230-247)."""
    info = os.path.join(egsdir, "info")
    if not os.path.isdir(info):
        raise ValueError(f"Expected dir {info} to exist.")
    with open(os.path.join(info, "feat_dim")) as f:
        feat_dim = int(f.read().split()[0])
    with open(os.path.join(info, "num_targets")) as f:
        num_targets = int(f.read().split()[0])
    train_csv = os.path.join(egsdir, train_csv_name or "train.egs.csv")
    valid_csv = os.path.join(egsdir, valid_csv_name or "valid.egs.csv")
    return feat_dim, num_targets, train_csv, valid_csv if os.path.exists(valid_csv) else None


def prepare_egs_dir(datadir_path: str, egs_dir: str, *, chunk_size: int = 200,
                    chunk_type: str = "speaker_balance", chunk_num_selection: int = 0, overlap: float = 0.1,
                    scale: float = 1.5, valid_num_utts: int = 0, valid_chunk_num: int = 2,
                    seed: int = 1024) -> Tuple[int, int]:
    """An egs dir from a feature data dir (parity:
    pipeline/onestep/get_chunk_egs.py:31-120): ``valid_num_utts``
    utterances held out (keeping >= 2 training utterances a speaker),
    sampled training chunks, sequential validation chunks (at most
    ``valid_chunk_num`` an utterance). Returns (feat_dim, num_targets)."""
    dd = DataDir.read(datadir_path)
    spk2int = {s: i for i, s in enumerate(sorted(set(dd.utt2spk().values())))}
    os.makedirs(os.path.join(egs_dir, "info"), exist_ok=True)

    valid_dd = None
    if valid_num_utts > 0:
        dd, valid_dd = dd.valid_split(num_utts=valid_num_utts, seed=seed)
    sampler = ChunkSamples(dd, chunk_size=chunk_size, chunk_type=chunk_type,
                           chunk_num_selection=chunk_num_selection, overlap=overlap, scale=scale, seed=seed,
                           spk2int=spk2int)
    sampler.write_csv(os.path.join(egs_dir, "train.egs.csv"))
    if valid_dd is not None:
        vs = ChunkSamples(valid_dd, chunk_size=chunk_size, chunk_type="sequential", overlap=0.0, seed=seed,
                          spk2int=spk2int)
        per_utt: Dict[str, int] = {}
        kept = []
        for c in vs.sample():
            if per_utt.get(c.utt, 0) < valid_chunk_num:
                kept.append(c)
                per_utt[c.utt] = per_utt.get(c.utt, 0) + 1
        vs.write_csv(os.path.join(egs_dir, "valid.egs.csv"), kept)

    feats = dd.tables.get("feats.scp", {})
    first = next(iter(sorted(feats.values())), None)
    if first is None:
        raise ValueError(f"{datadir_path} has no feats.scp entries")
    feat_dim = int(read_mat(first, row_range=(0, 1)).shape[1])
    num_targets = len(spk2int)
    with open(os.path.join(egs_dir, "info", "feat_dim"), "w") as f:
        f.write(f"{feat_dim}\n")
    with open(os.path.join(egs_dir, "info", "num_targets"), "w") as f:
        f.write(f"{num_targets}\n")
    return feat_dim, num_targets


def read_ali_scp(path: str) -> Dict[str, str]:
    """utt -> alignment rxfile (the ali.scp ali-to-phones writes)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def read_utt2label(path: str) -> Dict[str, int]:
    """A two-column ``utt int`` file (the FD egs' auxiliary class labels)."""
    with open(path) as f:
        return {k: int(v) for k, v in (line.split(None, 1) for line in f if line.strip())}


def build_chunk_egs_from_dir(cfg: Dict, worker_id: int = 0, num_workers: int = 1,
                             probe: bool = False) -> "ChunkEgs":
    """Module-level ChunkEgs factory (picklable for the spawn workers of
    MultiprocessLoader): worker ``worker_id`` of ``num_workers`` takes
    ``rank::world_size`` of each epoch's order. ``cfg["ali_scp"]`` builds
    the dual-label ChunkEgsMultiTask; ``cfg["aux_utt2label"]`` adds
    ``aux_y``."""
    kwargs = dict(batch_size=cfg["batch_size"], seed=cfg.get("seed", 1024), rank=worker_id,
                  world_size=num_workers, aug=cfg.get("aug"), aug_params=cfg.get("aug_params"),
                  utt2aux=read_utt2label(cfg["aux_utt2label"]) if cfg.get("aux_utt2label") else None)
    chunks = read_chunk_csv(cfg["train_csv"])
    if cfg.get("ali_scp"):
        return ChunkEgsMultiTask(chunks, read_ali_scp(cfg["ali_scp"]), **kwargs)
    return ChunkEgs(chunks, **kwargs)


def read_chunk_csv(path: str) -> List[Chunk]:
    out = []
    with open(path) as f:
        r = csv.reader(f)
        next(r, None)
        for row in r:
            if len(row) == 5:
                out.append(Chunk(row[0], row[1], int(row[2]), int(row[3]), int(row[4])))
    return out


class ChunkEgs:
    """Chunk dataset over Kaldi arks with a seeded order per epoch and
    fixed-shape batches (parity: ChunkEgs egs.py:28-105 + BaseBunch).

    A batch is ``{"x": [B, chunk, D] f32, "y": [B] int32, "keys"}`` (and
    ``"aux_y"`` [B] int32 given ``utt2aux``). ``aug`` ("specaugment" or
    "cutout", data/augment.py get_augmentation) runs per chunk, drawn from
    one generator seeded ``seed + 7`` for the dataset's life."""

    def __init__(self, chunks: Sequence[Chunk], batch_size: int = 64, seed: int = 1024, rank: int = 0,
                 world_size: int = 1, drop_last: bool = True, aug: Optional[str] = None,
                 aug_params: Optional[Dict] = None, utt2aux: Optional[Dict[str, int]] = None):
        from .augment import get_augmentation

        self.chunks = list(chunks)
        self.batch_size = batch_size
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.epoch = 0
        self.aug_fn = get_augmentation(aug, aug_params)
        self._aug_rng = np.random.default_rng(seed + 7)
        self.utt2aux = utt2aux

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.chunks) // self.world_size
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        order = np.random.default_rng(self.seed + self.epoch).permutation(len(self.chunks))
        batch: List[Chunk] = []
        for idx in order[self.rank::self.world_size]:
            batch.append(self.chunks[int(idx)])
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._collate(batch)

    def _collate(self, batch: List[Chunk]) -> Dict:
        feats = [read_mat(c.rxfile, row_range=(c.start, c.end)) for c in batch]
        if self.aug_fn is not None:
            feats = [self.aug_fn(f, self._aug_rng) for f in feats]
        out = {"x": np.stack(feats).astype(np.float32), "y": np.asarray([c.label for c in batch], np.int32),
               "keys": [c.utt for c in batch]}
        if self.utt2aux is not None:
            out["aux_y"] = np.asarray([self.utt2aux[c.utt] for c in batch], np.int32)
        return out


class ChunkEgsMultiTask(ChunkEgs):
    """Dual-label chunk egs for multi-task (speaker, phone) training
    (parity: pytorch/libs/egs/egs_multi_task.py:28-123): each batch also
    holds ``"phone_y"`` [B, chunk], the chunk's rows of the utterance's
    alignment (an int-vector ali-to-phones entry or a one-column float
    matrix, io/kaldi.py read_ali)."""

    def __init__(self, chunks, ali_rxfiles: Dict[str, str], **kwargs):
        super().__init__(chunks, **kwargs)
        self.ali_rxfiles = ali_rxfiles

    def _collate(self, batch):
        out = super()._collate(batch)
        out["phone_y"] = np.stack([read_ali(self.ali_rxfiles[c.utt], row_range=(c.start, c.end)) for c in batch])
        return out
