"""Kaldi vector ark/scp writing (the port's own numpy copy).

Counterpart: asv_subtools_tpu/io/kaldi.py:341-361 (write_vec_flt) and
:571-597 (ArkScpWriter), binary format only: ``key \\0B FV <dim> data``.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Optional

import numpy as np


def _write_int32(fd: BinaryIO, v: int) -> None:
    fd.write(b"\x04" + struct.pack("<i", v))


def write_vec_flt(fd: BinaryIO, vec: np.ndarray, key: str) -> int:
    """Write 'key \\0B FV <dim> data' to an open binary file. Returns the
    byte offset of the value (for the scp)."""
    fd.write((key + " ").encode())
    offset = fd.tell()
    fd.write(b"\x00B")
    v = np.ascontiguousarray(vec)
    if v.dtype == np.float64:
        fd.write(b"DV ")
    else:
        v = v.astype(np.float32)
        fd.write(b"FV ")
    _write_int32(fd, v.shape[0])
    fd.write(v.tobytes())
    return offset


class ArkScpWriter:
    """Paired vector ark+scp writer (Kaldi 'ark,scp:xvector.ark,xvector.scp')."""

    def __init__(self, ark_path: str, scp_path: Optional[str] = None):
        self.ark_path = os.path.abspath(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None

    def write(self, key: str, array: np.ndarray) -> None:
        offset = write_vec_flt(self._ark, array, key)
        if self._scp:
            self._scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
