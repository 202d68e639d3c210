"""Composable data-pipeline stages (the port's own numpy copy).

Counterpart: asv_subtools_tpu/data/processor.py, behaviour unchanged
(parity: pytorch/libs/egs/processor.py). wenet-style: each stage is a
generator transform over sample dicts `{"key", "wav", "sample_rate",
"label", ...}`. Stages compose with `Pipeline([...])`. `pad_batch` can pad
every batch to a small set of static bucket lengths (the reference pads
dynamically, processor.py:609-634).

Only `compute_feats` touches torch, inside its stage, on the CPU: a
pipeline of waves runs on numpy and scipy alone.
"""

from __future__ import annotations

import math
import random
import tarfile
import zlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


class EpochState:
    """Mutable epoch holder shared by the random stages so per-utterance RNG
    re-randomizes every epoch (the reference re-seeds dataloader workers per
    epoch via set_epoch, egs_online.py:125-128). `WavEgs.set_epoch` updates
    this in place; stages fold `.epoch` into their per-sample seed."""

    def __init__(self, epoch: int = 0):
        self.epoch = epoch


def _sample_seed(seed: int, key: str, epoch: Optional[EpochState] = None) -> int:
    """Stable per-(utterance, epoch) seed.

    crc32 instead of str.__hash__: the latter is salted per process, which
    makes augmentation irreproducible across runs/hosts; crc32 is stable.
    The epoch is mixed with a golden-ratio constant so consecutive epochs
    draw independent augmentations."""
    ep = epoch.epoch if epoch is not None else 0
    return (seed + zlib.crc32(key.encode()) + ep * 0x9E3779B1) % (2**31)

from ..io.wav import read_wav
from .augment import SpeechAug, spec_augment
from .signal import de_silence as _de_silence, resample as _resample


Sample = Dict


class Pipeline:
    """Chain of stages applied to a source iterable."""

    def __init__(self, source: Iterable, stages: Sequence[Callable]):
        self.source = source
        self.stages = list(stages)

    def __iter__(self):
        it = iter(self.source)
        for stage in self.stages:
            it = stage(it)
        return it


# -- sources ----------------------------------------------------------------


def wav_scp_source(
    wav_scp: str, utt2spk: Optional[str] = None, spk2int: Optional[Dict] = None
) -> Iterator[Sample]:
    """Yield {"key", "path", "label"} from Kaldi wav.scp (+utt2spk)."""
    labels = {}
    if utt2spk:
        with open(utt2spk) as f:
            for line in f:
                u, s = line.split()[:2]
                labels[u] = spk2int[s] if spk2int else s
    with open(wav_scp) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) != 2:
                continue
            key, path = parts
            yield {"key": key, "path": path, "label": labels.get(key, -1)}


def tar_shard_source(shard_list: Sequence[str]) -> Iterator[Sample]:
    """Yield samples from wenet-style tar shards: entries <key>.wav with
    sidecar <key>.spk label files (parity: tar_file_and_group
    processor.py:59-111)."""
    for shard in shard_list:
        with tarfile.open(shard) as tf:
            group: Dict[str, Dict] = {}
            for member in tf:
                name = member.name
                key, _, ext = name.rpartition(".")
                entry = group.setdefault(key, {"key": key})
                data = tf.extractfile(member).read()
                if ext == "wav":
                    entry["wav_bytes"] = data
                elif ext in ("spk", "label", "txt"):
                    entry["label"] = data.decode().strip()
            for key, entry in group.items():
                if "wav_bytes" in entry:
                    yield entry


def write_tar_shards(
    entries,
    out_dir: str,
    *,
    num_per_shard: int = 1000,
    prefix: str = "shards",
):
    """Pack (key, wav_path, label) entries into wenet-style tar shards
    readable by tar_shard_source (parity: pipeline make_shard_list.py —
    the online-egs shard packer). Returns the list of shard paths.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    entries = list(entries)
    shard_paths = []
    for si in range(0, len(entries), num_per_shard):
        path = os.path.join(
            out_dir, f"{prefix}_{si // num_per_shard:06d}.tar"
        )
        with tarfile.open(path, "w") as tf:
            for key, wav_path, label in entries[si : si + num_per_shard]:
                tf.add(wav_path, arcname=f"{key}.wav")
                data = str(label).encode()
                info = tarfile.TarInfo(f"{key}.spk")
                info.size = len(data)
                import io

                tf.addfile(info, io.BytesIO(data))
        shard_paths.append(path)
    with open(os.path.join(out_dir, "shard_list.txt"), "w") as f:
        f.write("\n".join(shard_paths) + "\n")
    return shard_paths


# -- stages -----------------------------------------------------------------


def parse_raw(samples: Iterator[Sample]) -> Iterator[Sample]:
    """Decode wav (path or bytes) -> float32 int16-scale waveform
    (processor.py:112-148)."""
    for s in samples:
        try:
            if "wav_bytes" in s:
                wav, sr = read_wav(s.pop("wav_bytes"))
            else:
                wav, sr = read_wav(s["path"])
            if wav.ndim > 1:
                wav = wav[0]
            s["wav"] = wav
            s["sample_rate"] = sr
            yield s
        except Exception:
            continue  # skip unreadable files (reference logs+skips)


def de_sil(min_eng: float = 50.0, win_len: float = 0.1):
    """Energy VAD on the waveform (processor.py:149-176)."""

    def stage(samples):
        for s in samples:
            s["wav"] = _de_silence(
                s["wav"], s.get("sample_rate", 16000), win_len=win_len, min_eng=min_eng
            )
            if len(s["wav"]):
                yield s

    return stage


def resample(target_sr: int = 16000):
    """(processor.py:280-303)."""

    def stage(samples):
        for s in samples:
            sr = s.get("sample_rate", 16000)
            if sr != target_sr:
                s["wav"] = _resample(s["wav"], sr, target_sr)
                s["sample_rate"] = target_sr
            yield s

    return stage


def filter_by_length(
    min_seconds: float = 0.5, max_seconds: float = 60.0
):
    """(processor.py:304-339)."""

    def stage(samples):
        for s in samples:
            dur = len(s["wav"]) / s.get("sample_rate", 16000)
            if min_seconds <= dur <= max_seconds:
                yield s

    return stage


def speed_perturb_stage(
    speeds: Sequence[float] = (0.9, 1.0, 1.1),
    expand_labels: bool = False,
    num_spks: int = 0,
    seed: int = 1024,
    epoch: Optional[EpochState] = None,
):
    """Random speed perturbation; optionally expands speaker labels 3-way
    (PreSpeedPerturb processor.py:177-218: label' = label + offset*num_spks).

    Label offsets are keyed by SPEED VALUE, not list position: clean 1.0x
    keeps the base label (offset 0) and each non-clean speed gets 1..n in
    listed order — mirroring _speed_to_speaker (speech_augment.py:1280-1290,
    speed==100 -> offset 0) regardless of where 1.0 sits in `speeds`."""
    from .augment import SpeedPerturb

    sp = SpeedPerturb(speeds)
    offsets: List[int] = []
    next_off = 1
    for v in speeds:
        if abs(v - 1.0) < 1e-9:
            offsets.append(0)
        else:
            offsets.append(next_off)
            next_off += 1

    def stage(samples):
        for s in samples:
            rng = np.random.default_rng(_sample_seed(seed, s["key"], epoch))
            wav, idx = sp(s["wav"], rng)
            s["wav"] = wav
            off = offsets[idx]
            if expand_labels and off != 0 and isinstance(s.get("label"), int):
                s["label"] = s["label"] + off * num_spks
            yield s

    return stage


def random_chunk(chunk_seconds: float = 2.015, seed: int = 1024,
                 epoch: Optional[EpochState] = None):
    """Random fixed-length chunk with repeat-padding for short utterances
    (processor.py:219-246)."""

    def stage(samples):
        for s in samples:
            sr = s.get("sample_rate", 16000)
            n = int(chunk_seconds * sr)
            wav = s["wav"]
            rng = np.random.default_rng(_sample_seed(seed, s["key"], epoch))
            if len(wav) >= n:
                start = int(rng.integers(len(wav) - n + 1))
                s["wav"] = wav[start : start + n]
            else:
                reps = -(-n // len(wav))
                s["wav"] = np.tile(wav, reps)[:n]
            yield s

    return stage


def speech_aug_stage(aug: SpeechAug, seed: int = 1024,
                     epoch: Optional[EpochState] = None):
    """Waveform augmentation (processor.py:340-386)."""

    def stage(samples):
        for s in samples:
            rng = np.random.default_rng(_sample_seed(seed, s["key"], epoch))
            s["wav"] = aug(s["wav"], rng)
            yield s

    return stage


def compute_feats(opts=None, feat_type: str = "fbank", cmvn: bool = True,
                  backend: str = "numpy"):
    """Kaldi-compatible features on the HOST, per sample (KaldiFeature
    processor.py:387-466): the port's ``features.compute_fbank`` or
    ``compute_mfcc`` (their FFT in float64, as the JAX package's numpy
    path computes it) and ``cmvn_utterance`` on CPU tensors, returned as
    float32 numpy. torch is imported when the stage runs, and nothing in
    it touches CUDA.

    feat_type: fbank | mfcc | fbank_pitch | mfcc_pitch. The *_pitch
    variants append the 3-dim Kaldi pitch feature of the float64 wave
    (features/pitch.py; reference makeFeatures.sh:36-45 ->
    make_fbank_pitch.sh: paste-feats of the base matrix with
    process-pitch-feats output), both cut to the shorter; CMVN runs over
    the concatenated matrix like apply-cmvn on the full dim (JAX
    data/processor.py:280-340). ``backend="numpy"`` names the JAX
    package's host path, which this stage matches. ``backend="native"``
    computes the base matrix with the C++ front end (features/native.py,
    within 1e-3 of fbank and 2e-3 of MFCC; pitch stays the port's) and
    raises ValueError here, before any utterance, for an option the C API
    cannot express (JAX computes those utterances with numpy instead).
    ``backend="auto"`` keeps JAX's choice per utterance: native where the
    options allow it and the C call succeeds, else the torch path. The
    library is built and loaded by the process that runs the stage (a
    spawned worker builds nothing when the file is current).
    """
    from ..features.config import FbankOptions, MfccOptions

    base_type = feat_type.replace("_pitch", "")
    with_pitch = feat_type.endswith("_pitch")
    if base_type not in ("fbank", "mfcc"):
        raise ValueError(f"unknown feat_type {feat_type!r}")
    if backend not in ("numpy", "native", "auto"):
        raise ValueError(f"unknown feature backend {backend!r} (numpy | native | auto)")
    if opts is None:
        opts = FbankOptions() if base_type == "fbank" else MfccOptions()
    use_native = False
    if backend != "numpy":
        from ..features import native

        bad = native.unsupported_option(opts, base_type)
        if backend == "native" and bad is not None:
            raise ValueError(f"feat_backend='native' cannot express {base_type} option {bad!r}; use 'numpy' "
                             "or 'auto'")
        use_native = bad is None

    def stage(samples):
        import torch

        from ..features import native
        from ..features.functional import cmvn_utterance, compute_fbank, compute_mfcc
        from ..features.pitch import PitchOptions, compute_and_process_pitch

        compute = compute_fbank if base_type == "fbank" else compute_mfcc
        compute_native = native.native_fbank if base_type == "fbank" else native.native_mfcc
        if use_native:
            native.load()  # a missing compiler or a failed build raises here, in every backend
        for s in samples:
            wav = torch.from_numpy(np.asarray(s["wav"], np.float32))
            with torch.no_grad():
                f = None
                if use_native:
                    try:
                        f = torch.from_numpy(compute_native(s["wav"], opts))
                    except native.NativeCallError:
                        # a failed C call: "auto" takes the torch path for
                        # this utterance, as JAX's None does; "native" raises
                        if backend == "native":
                            raise
                if f is None:
                    f = compute(wav, opts, fft_mode="rfft")
                if with_pitch:
                    popts = PitchOptions(samp_freq=float(s.get("sample_rate", 16000)))
                    p = compute_and_process_pitch(np.asarray(s["wav"], np.float64), popts)
                    n = min(len(f), len(p))
                    f = torch.cat([f[:n], torch.from_numpy(p[:n].astype(np.float32))], dim=1)
                if cmvn:
                    f = cmvn_utterance(f)
            s["feat"] = f.numpy().astype(np.float32, copy=False)
            yield s

    return stage


def spec_aug_stage(
    num_t_mask: int = 1, num_f_mask: int = 1, max_t: int = 50, max_f: int = 10,
    seed: int = 1024,
    epoch: Optional[EpochState] = None,
):
    """(processor.py:469-494)."""

    def stage(samples):
        for s in samples:
            rng = np.random.default_rng(_sample_seed(seed, s["key"], epoch))
            s["feat"] = spec_augment(
                s["feat"], rng, num_t_mask, num_f_mask, max_t, max_f
            )
            yield s

    return stage


def shuffle(buffer_size: int = 1000, seed: int = 1024,
            epoch: Optional[EpochState] = None):
    """Reservoir shuffle (processor.py:495-520)."""

    def stage(samples):
        rng = random.Random(seed + (epoch.epoch if epoch is not None else 0))
        buf: List[Sample] = []
        for s in samples:
            buf.append(s)
            if len(buf) >= buffer_size:
                rng.shuffle(buf)
                while buf:
                    yield buf.pop()
        rng.shuffle(buf)
        while buf:
            yield buf.pop()

    return stage


def sort_by_length(buffer_size: int = 500, key: str = "wav"):
    """Local length sort for efficient bucketing (processor.py:521-547)."""

    def stage(samples):
        buf: List[Sample] = []
        for s in samples:
            buf.append(s)
            if len(buf) >= buffer_size:
                buf.sort(key=lambda x: len(x[key]))
                yield from buf
                buf = []
        buf.sort(key=lambda x: len(x[key]))
        yield from buf

    return stage


def static_batch(batch_size: int = 16, drop_last: bool = False):
    """Fixed-count batching (processor.py:548-566). drop_last=True keeps
    every batch exactly batch_size."""

    def stage(samples):
        buf: List[Sample] = []
        for s in samples:
            buf.append(s)
            if len(buf) >= batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return stage


def dynamic_batch(max_frames_in_batch: int = 12000, key: str = "feat"):
    """Max-total-frames batching (processor.py:567-594)."""

    def stage(samples):
        buf: List[Sample] = []
        longest = 0
        for s in samples:
            l = len(s[key])
            longest = max(longest, l)
            if buf and longest * (len(buf) + 1) > max_frames_in_batch:
                yield buf
                buf = [s]
                longest = l
            else:
                buf.append(s)
        if buf:
            yield buf

    return stage


def pad_batch(
    key: str = "feat", bucket_lengths: Optional[Sequence[int]] = None
):
    """Collate a list of samples into {'x', 'y', 'mask'} arrays.

    With `bucket_lengths`, every batch is padded up to the smallest bucket
    >= its longest item, so the device sees a few static shapes (reference
    padding processor.py:609-634).
    """

    def stage(batches):
        for batch in batches:
            items = [np.asarray(s[key]) for s in batch]
            lens = np.asarray([len(x) for x in items])
            max_len = int(lens.max())
            if bucket_lengths is not None:
                fit = [b for b in bucket_lengths if b >= max_len]
                max_len = min(fit) if fit else max_len
            feat_shape = items[0].shape[1:]
            out = np.zeros((len(items), max_len) + feat_shape, np.float32)
            for i, x in enumerate(items):
                out[i, : len(x)] = x[:max_len]
            mask = np.arange(max_len)[None, :] < lens[:, None]
            labels = np.asarray(
                [s.get("label", -1) for s in batch], np.int32
            )
            yield {
                "x": out,
                "y": labels,
                "mask": mask,
                "keys": [s["key"] for s in batch],
            }

    return stage
