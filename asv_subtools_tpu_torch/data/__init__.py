"""Data pipeline: wav sources, augmentation, chunking, batching, and the
offline chunk egs over feature arks (numpy and scipy; counterpart:
asv_subtools_tpu/data)."""

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
from .egs_offline import (
    Chunk,
    ChunkEgs,
    ChunkEgsMultiTask,
    ChunkSamples,
    build_chunk_egs_from_dir,
    get_info_from_egsdir,
    prepare_egs_dir,
    read_ali_scp,
    read_chunk_csv,
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
