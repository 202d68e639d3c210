"""RIFF wav reading/writing (the port's own numpy copy of
asv_subtools_tpu/io/wav.py; parity: runtime/frontend/wav.h:1-205 and the
data pipeline's parse_raw, pytorch/libs/egs/processor.py:112-148).

Returns float32 waveforms in Kaldi's int16 sample scale ([-32768, 32767])
— the scale every feature config in the reference assumes.
"""

from __future__ import annotations

import io
import struct
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(
    path_or_bytes, *, normalize: bool = False
) -> Tuple[np.ndarray, int]:
    """Read a PCM wav -> (samples [T] or [C, T] float32, sample_rate).

    normalize=False keeps Kaldi int16 scale; True scales to [-1, 1].
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        fobj = io.BytesIO(path_or_bytes)
    else:
        fobj = path_or_bytes
    with wave.open(fobj, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).T
    if normalize:
        data = data / 32768.0
    return data, sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono/multichannel float32 (int16 scale) as PCM16 wav."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    pcm = np.clip(x, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())
