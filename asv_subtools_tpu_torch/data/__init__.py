"""Data pipeline: wav sources, augmentation, chunking, batching (numpy and
scipy; counterpart: asv_subtools_tpu/data). The offline chunk egs
(asv_subtools_tpu/data/egs_offline.py) are not ported yet (ROADMAP)."""

from . import processor
from .augment import (
    AddBabble,
    AddNoise,
    AddReverb,
    DoClip,
    DropChunk,
    DropFreq,
    EnvCorrupt,
    NoiseManifest,
    SpeechAug,
    SpeedPerturb,
    TimeDomainSpecAugment,
    spec_augment,
    speech_aug_from_config,
)
from .dataset import (
    DistributedShardList,
    MultiprocessLoader,
    ParallelMapper,
    Prefetcher,
    WavEgs,
    WavEgsXvector,
    build_spk2int,
)
from .signal import (
    compute_amplitude,
    convolve1d,
    de_silence,
    normalize_amplitude,
    notch_filter,
    overlap_and_add,
    rescale_amplitude,
    resample,
    reverberate,
    speed_perturb,
)
