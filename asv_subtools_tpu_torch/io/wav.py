"""RIFF wav reading (the port's own numpy copy of asv_subtools_tpu/io/wav.py:18-48).

Returns float32 waveforms in Kaldi's int16 sample scale ([-32768, 32767]),
the scale every feature config assumes.
"""

from __future__ import annotations

import io
import wave
from typing import Tuple

import numpy as np


def read_wav(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Read a PCM wav (path or bytes) -> (samples [T] or [C, T] float32 in
    Kaldi int16 scale, sample_rate)."""
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
    return data, sr
